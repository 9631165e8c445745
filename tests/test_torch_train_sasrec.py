"""SASRec training in the port against the JAX package, at a small size: the
training arrays, the loss and its gradients (without dropout, and with both
packages handed the same dropout masks in the same order), one epoch of the
sequence trainer on batches formed by the JAX code, the per-position
negatives, and end to end ``SASRec(cfg, device="cpu").train(data)``, whose
best checkpoint the JAX package loads and tests to the port's metrics."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import beta_recsys_tpu.models.sasrec as jax_sasrec_module
import beta_recsys_tpu.ops.attention as jax_attention
from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.core.train_engine import make_sequence_epoch_fn as jax_make_sequence_epoch_fn
from beta_recsys_tpu.data.sequential_data import SequentialData as JaxSequentialData
from beta_recsys_tpu.models.sasrec import SASRec as JaxSASRec
from beta_recsys_tpu.recommenders import SASRec as JaxSASRecRecommender
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.convert import sasrec_params_from_jax
from beta_recsys_tpu_torch.core.checkpoint import load_raw_checkpoint
from beta_recsys_tpu_torch.core.train_engine import SequenceEpochTrainer, make_negative_sampler, make_optimizer
from beta_recsys_tpu_torch.data.sequential_data import SequentialData
from beta_recsys_tpu_torch.models.sasrec import SASRec
from beta_recsys_tpu_torch.ops import attention as port_attention
from beta_recsys_tpu_torch.ops.kernels import flash_attention as port_flash
from beta_recsys_tpu_torch.recommenders import SASRec as SASRecRecommender
from beta_recsys_tpu_torch.utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)

TOL = 1e-5  # float32 through 2 blocks and their gradients, summed in other orders
N_USERS, N_ITEMS, MAXLEN, D = 40, 60, 12, 16


def sequence_split(n_users=N_USERS, n_items=N_ITEMS, n_negative=15, seed=0):
    """Leave-one-out frames with sequences to learn: user u's items come
    from the class u mod 4 in a fixed order; 3 to 15 interactions a user (1
    to 13 in train), timestamps out of row order; the newest interaction is
    the test positive, the one before it the validation positive, each
    beside ``n_negative`` items the user never had."""
    rng = np.random.default_rng(seed)
    users, items, stamps = [], [], []
    for u in range(n_users):
        count = int(rng.integers(3, 16))
        liked = np.arange(u % 4, n_items, 4)
        start = int(rng.integers(0, len(liked)))
        users += [u] * count
        items += list(np.roll(liked, -start)[:count])
        stamps += list(np.sort(rng.choice(10**6, count, replace=False)))
    users, items, stamps = np.array(users), np.array(items), np.array(stamps)
    perm = rng.permutation(len(users))
    users, items, stamps = users[perm], items[perm], stamps[perm]
    rank = np.zeros(len(users), int)  # 1 = a user's newest
    for u in range(n_users):
        at = np.nonzero(users == u)[0]
        rank[at[np.argsort(-stamps[at])]] = np.arange(1, len(at) + 1)

    def frame(sel, u=None, i=None, r=None):
        u = users[sel] if u is None else u
        return {DEFAULT_USER_COL: u + 1, DEFAULT_ITEM_COL: (items[sel] if i is None else i) + 1,
                DEFAULT_RATING_COL: np.ones(len(u), np.float32) if r is None else r,
                DEFAULT_TIMESTAMP_COL: stamps[sel] if i is None else np.zeros(len(u), np.int64)}

    def with_negatives(pos):
        neg_u, neg_i = [], []
        for u in range(n_users):
            free = np.setdiff1d(np.arange(n_items), items[users == u])
            neg_u += [u] * n_negative
            neg_i += list(rng.choice(free, n_negative, replace=False))
        neg = frame(None, np.array(neg_u), np.array(neg_i), np.zeros(len(neg_u), np.float32))
        return {c: np.concatenate([pos[c], neg[c]]) for c in pos}

    return frame(rank > 2), [with_negatives(frame(rank == 2))], [with_negatives(frame(rank == 1))]


@pytest.fixture(scope="module")
def split():
    return sequence_split()


def _both_data(split):
    train, valid, test = split
    return SequentialData(split), JaxSequentialData(
        (pd.DataFrame(train), [pd.DataFrame(f) for f in valid], [pd.DataFrame(f) for f in test]))


def _models(data, ctx=None, **cfg):
    """The JAX model and the port's on the JAX initializer's parameters."""
    cfg = {"model": "SASRec", "emb_dim": D, "num_blocks": 2, "num_heads": 2, "maxlen": MAXLEN,
           "dropout_rate": 0.0, "l2_emb": 0.1, "lr": 1e-3, "optimizer": "adam", **cfg}
    artifacts = {"ctx": ctx} if ctx is not None else None
    ref = JaxSASRec(cfg, data.n_users, data.n_items, artifacts=artifacts)
    params = ref.init_params(jax.random.key(0))
    ours = SASRec(cfg, data.n_users, data.n_items, artifacts=artifacts, device="cpu")
    ours.load_state_dict(sasrec_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return cfg, ref, params, ours


def _batch(data, n=6, seed=1):
    """A training batch of the split's arrays with random negatives."""
    arrays = data.train_seq_arrays(MAXLEN)
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, len(arrays["users"]), n)
    seq, pos = arrays["seq"][rows], arrays["pos"][rows]
    neg = np.where(pos != 0, rng.integers(1, data.n_items + 1, pos.shape), 0).astype(np.int32)
    return {"users": arrays["users"][rows], "seq": seq, "pos": pos, "neg": neg}


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _check_grads(ours, jax_grads):
    want = sasrec_params_from_jax(jax.tree_util.tree_map(np.asarray, jax_grads))
    for name, p in ours.named_parameters():
        _close(p.grad, want[name], what=name)


@pytest.mark.parametrize("maxlen", [3, MAXLEN, 25])
def test_train_seq_arrays_match_jax(split, maxlen):
    data, jax_data = _both_data(split)
    got, want = data.train_seq_arrays(maxlen), jax_data.train_seq_arrays(maxlen)
    assert set(got) == set(want) == {"users", "seq", "pos"}
    for key in want:
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(got["users"]) < data.n_users  # users with one train item are left out


@pytest.mark.parametrize("fused", ["auto", False], ids=["flash-plain", "autograd"])
def test_loss_and_gradients_match_jax_without_dropout(split, fused):
    data, _ = _both_data(split)
    _, ref, params, ours = _models(data, fused_attention=fused)
    batch = _batch(data)
    loss = ours.loss({k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()})
    loss.backward()
    want_loss, want_grads = jax.value_and_grad(ref.loss)(params, jax.tree_util.tree_map(jnp.asarray, batch), None)
    _close(loss, want_loss)
    _check_grads(ours, want_grads)


def test_loss_and_gradients_match_jax_with_the_same_dropout_masks(split, monkeypatch):
    """Both packages are handed the same masks, drawn in the same order:
    the embedding, then per block the attention probabilities, FFN 1 and
    FFN 2 (the port's attention mask is asked for again, by seed, in the
    backward)."""
    data, _ = _both_data(split)
    rate = 0.3
    _, ref, params, ours = _models(data, dropout_rate=rate)
    batch = _batch(data)
    B, T, H = batch["seq"].shape[0], MAXLEN, 2
    rng = np.random.default_rng(7)
    shapes = [(B, T, D)] + [(B, H, T, T), (B, T, D), (B, T, D)] * 2
    masks = [rng.random(shape) >= rate for shape in shapes]

    jax_calls = []

    def jax_dropout(key, x, r):
        keep = masks[len(jax_calls)]
        jax_calls.append(x.shape)
        return jnp.where(keep, x / (1 - r), 0.0)

    monkeypatch.setattr(jax_attention, "_dropout", jax_dropout)
    monkeypatch.setattr(jax_sasrec_module, "inverted_dropout", jax_dropout)
    want_loss, want_grads = jax.value_and_grad(ref.loss)(
        params, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.key(3))
    assert jax_calls == [tuple(s) for s in shapes]

    port_calls, by_seed = [], {}

    def port_mask(generator, shape, r, device):
        port_calls.append(tuple(shape))
        return torch.from_numpy(masks[len(port_calls) - 1])

    def port_attention_mask(seed, n, t, r):
        key = int(seed)
        if key not in by_seed:
            port_calls.append((n, t, t))
            by_seed[key] = torch.from_numpy(masks[len(port_calls) - 1].reshape(n, t, t))
        return by_seed[key]

    monkeypatch.setattr(port_attention, "dropout_mask", port_mask)
    monkeypatch.setattr(port_flash, "dropout_keep_mask", port_attention_mask)
    loss = ours.loss({k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()},
                     torch.Generator().manual_seed(0))
    loss.backward()
    assert port_calls == [(B, T, D)] + [(B * H, T, T), (B, T, D), (B, T, D)] * 2
    _close(loss, want_loss)
    _check_grads(ours, want_grads)


def test_no_generator_means_no_dropout(split):
    data, _ = _both_data(split)
    _, _, _, ours = _models(data, dropout_rate=0.5)
    batch = {k: torch.as_tensor(v, dtype=torch.long) for k, v in _batch(data).items()}
    assert torch.equal(ours.loss(batch), ours.loss(batch))
    assert not torch.equal(ours.loss(batch, torch.Generator().manual_seed(0)), ours.loss(batch))


def jax_sequence_batches(rng, jax_data, neg_sampler, batch_size):
    """The (rows, users, neg0) a JAX sequence epoch forms from ``rng``, as
    ``make_sequence_epoch_fn`` forms them."""
    arrays = jax_data.train_seq_arrays(MAXLEN)
    n = len(arrays["users"])
    num_batches = max(n // batch_size, 1)
    _, k_row, k_neg, _ = jax.random.split(rng, 4)
    rows = jax.random.randint(k_row, (num_batches, batch_size), 0, n)
    users = jnp.asarray(arrays["users"])[rows]
    neg0 = neg_sampler(k_neg, users[..., None], (num_batches, batch_size, MAXLEN))
    return tuple(np.array(x) for x in (rows, users, neg0))


def test_sequence_epoch_matches_jax(split):
    """One epoch (3 Adam steps at lr 1e-3) on JAX-formed batches. Adam's
    first steps move each parameter by about lr * sign(gradient), which
    magnifies rounding only where a gradient is rounding-sized; SASRec's
    gradients at the JAX initialisation are not, so the trainers agree to
    float tolerance (the table rows no batch touches get zero gradients and
    stay put on both sides)."""
    data, jax_data = _both_data(split)
    cfg, ref, params, ours = _models(data)
    batch_size = 10
    opt = optax.adam(cfg["lr"])
    neg_sampler = jax_make_negative_sampler(jax_data)
    jax_epoch = jax_make_sequence_epoch_fn(ref, opt, jax_data.train_seq_arrays(MAXLEN), batch_size,
                                           neg_sampler, donate=False)
    rng = jax.random.key(4)
    batches = jax_sequence_batches(rng, jax_data, neg_sampler, batch_size)
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)

    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = SequenceEpochTrainer(ours, optimizer, data.train_seq_arrays(MAXLEN), batch_size,
                                   make_negative_sampler(data, device="cpu"))
    assert trainer.num_batches == batches[0].shape[0] == 3
    _close(trainer.run_batches(*batches), want_loss)
    want = sasrec_params_from_jax(jax.tree_util.tree_map(np.asarray, want_params))
    for name, p in ours.named_parameters():
        _close(p, want[name], what=name)
        assert int(optimizer.state[p]["step"]) == int(want_state[0].count) == 3


def test_sequence_negatives_are_non_positive_and_uniform(split):
    """Per-position negatives from the trainer's own batch forming: 0-indexed
    draws, rejected against each user's train positives (4 rounds, so a
    collision survives with probability (d/n)^5), uniform over the rest."""
    data, _ = _both_data(split)
    _, _, _, ours = _models(data)
    trainer = SequenceEpochTrainer(ours, None, data.train_seq_arrays(MAXLEN), 8, make_negative_sampler(data, device="cpu"))
    draws_u, draws_i = [], []
    gen = torch.Generator().manual_seed(0)
    for _ in range(40):
        rows, users, neg0 = trainer.form(gen)
        assert rows.shape == users.shape == (trainer.num_batches, 8) and neg0.shape == (*rows.shape, MAXLEN)
        assert torch.equal(users, trainer.users[rows])
        draws_u.append(users[..., None].expand(neg0.shape).reshape(-1))
        draws_i.append(neg0.reshape(-1))
    users, items = torch.cat(draws_u).numpy(), torch.cat(draws_i).numpy()
    assert items.min() >= 0 and items.max() < data.n_items
    positive = data.pos_bitmask()
    share = positive.sum(axis=1) / data.n_items  # of each user's catalog
    hits = positive[users, items]
    expected = (share[users] ** 5).sum()
    assert hits.sum() <= expected + 5 * np.sqrt(expected) + 1
    free = ~positive[users]  # (draws, n_items): the items each draw may land on
    want = (free / free.sum(axis=1, keepdims=True)).sum(axis=0)
    got = np.bincount(items[~hits], minlength=data.n_items)
    assert (np.abs(got - want) <= 5 * np.sqrt(want) + 1).all()


def _config(root, **model):
    return {
        "system": {"root_dir": str(root), "metrics": ["ndcg", "recall"], "k": [5, 10], "valid_metric": "ndcg",
                   "valid_k": 10, "seed": 7, "result_file": "sasrec_test.csv", "save_last_every": 2},
        "dataset": {"dataset": "synthetic", "data_split": "leave_one_out"},
        "model": {"model": "SASRec", "emb_dim": D, "num_blocks": 2, "num_heads": 2, "maxlen": MAXLEN,
                  "batch_size": 8, "dropout_rate": 0.2, "l2_emb": 0.0, "optimizer": "adam", "lr": 0.01,
                  "max_epoch": 4, "max_n_update": 10, **model},
    }


def test_training_runs_and_the_jax_package_loads_the_checkpoint(split, tmp_path):
    data, jax_data = _both_data(split)
    rec = SASRecRecommender(Config(_config(tmp_path / "port")), device="cpu")
    result = rec.train(data)
    ours = rec.test()
    assert len(rec.engine.bookkeeper.history) == 4 and 0 <= result["best_epoch"] < 4
    assert np.isfinite(result["valid_metric"]) and result["valid_metric"] > 0
    raw = load_raw_checkpoint(result["model_save_dir"])
    mu = raw["opt_state"]["0"]["mu"]
    assert set(mu) == set(raw["params"]) and mu["blocks"]["1"]["attn"]["wq"].shape == (D, D)
    assert int(raw["opt_state"]["0"]["count"]) == (result["best_epoch"] + 1) * rec.engine.epoch_fn.num_batches

    jax_cfg = JaxConfig(json.loads(json.dumps(_config(tmp_path / "jax"))))
    ref = JaxSASRecRecommender(jax_cfg).load(result["model_save_dir"], jax_data)
    want = ref.test()
    assert list(ours) == sorted(want)
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    users = np.arange(10)
    got_rec, want_rec = rec.recommend(users=users, k=5), ref.recommend(users=users, k=5)
    np.testing.assert_array_equal(got_rec[DEFAULT_ITEM_COL], want_rec[DEFAULT_ITEM_COL].to_numpy())
    assert os.path.exists(os.path.join(result["model_save_dir"], "last", "checkpoint.msgpack"))
