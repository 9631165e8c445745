"""MF training in the port against the JAX package: one epoch of the dense
trainer and of the lazy-Adam trainer ("xla", and "fused" through its plain
version; the packed layouts in tests/test_torch_row_layouts.py) on batches
formed by the JAX code give the JAX parameters and moments; the sparse step count carries across epochs; and end to end,
``MatrixFactorization(cfg, device="cpu").train(data)`` learns a structured
split, and its best checkpoint loads in the JAX package with equal test
metrics."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.sparse_optim import init_sparse_state as jax_init_sparse_state
from beta_recsys_tpu.core.sparse_optim import make_sparse_epoch_fn as jax_make_sparse_epoch_fn
from beta_recsys_tpu.core.train_engine import _padded_order as jax_padded_order
from beta_recsys_tpu.core.train_engine import make_epoch_fn as jax_make_epoch_fn
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.models.mf import MF as JaxMF
from beta_recsys_tpu.recommenders import MatrixFactorization as JaxMatrixFactorization
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.convert import mf_params_from_jax
from beta_recsys_tpu_torch.core.checkpoint import load_metadata, load_raw_checkpoint
from beta_recsys_tpu_torch.core.sparse_optim import SparseEpochTrainer
from beta_recsys_tpu_torch.core.train_engine import (
    _padded_order,
    make_epoch_fn,
    make_negative_sampler,
    make_optimizer,
)
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.models.mf import MF
from beta_recsys_tpu_torch.recommenders import MatrixFactorization
from beta_recsys_tpu_torch.utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)

# float32 Adam over a few steps, gradients summed in other orders on the two
# sides (and torch's Adam divides by sqrt of the bias correction where optax
# divides the moment): a few ulp a step.
TOL = 1e-5
D, BATCH, LR, REG = 8, 64, 0.05, 0.01


def structured_split(n_users=60, n_items=40, per_user=8, n_negative=20, seed=0):
    """Leave-one-out frames MF can learn: user u likes the items congruent to
    u mod 4. Each user's newest item is the test positive, the one before it
    the validation positive, each beside ``n_negative`` items the user never
    had."""
    rng = np.random.default_rng(seed)
    users, items = [], []
    for u in range(n_users):
        users += [u] * per_user
        items += list(rng.choice(np.arange(u % 4, n_items, 4), per_user, replace=False))
    users, items = np.array(users), np.array(items)
    stamps = np.arange(len(users))
    from_end = per_user - np.tile(np.arange(per_user), n_users)  # 1 = newest

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

    return frame(from_end > 2), [with_negatives(frame(from_end == 2))], [with_negatives(frame(from_end == 1))]


@pytest.fixture(scope="module")
def split():
    return structured_split()


def _both_data(split):
    train, valid, test = split
    return BaseData(split), JaxBaseData((pd.DataFrame(train), [pd.DataFrame(f) for f in valid],
                                         [pd.DataFrame(f) for f in test]))


def _models(data, seed=0):
    """The JAX model and the port's on the same well-conditioned params.

    At the reference's initialisation (zero biases, embeddings of scale 0.1)
    the bias gradients of the BPR loss are differences of nearly equal
    sigmoid slopes, so their low bits are rounding, and Adam's first steps
    (about lr * g / |g|) turn that rounding into lr-sized moves: two float32
    implementations part by ~5e-4 there after one step. Embeddings of scale
    1 and random biases give logits far apart, where every gradient is well
    above its rounding, so the trainers are held to float tolerance."""
    cfg = {"model": "MF", "emb_dim": D, "reg": REG, "lr": LR, "optimizer": "adam", "stddev": 1.0}
    ref = JaxMF(cfg, data.n_users, data.n_items)
    params = jax.tree_util.tree_map(np.asarray, ref.init_params(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params["user_bias"] = (0.5 * rng.standard_normal(data.n_users)).astype(np.float32)
    params["item_bias"] = (0.5 * rng.standard_normal(data.n_items)).astype(np.float32)
    params["global_bias"] = np.float32(0.3)
    ours = MF(cfg, data.n_users, data.n_items, device="cpu")
    ours.load_state_dict(mf_params_from_jax(params))
    return cfg, ref, jax.tree_util.tree_map(jnp.asarray, params), ours


def jax_epoch_batches(rng, jax_data, batch_size):
    """The batches a JAX epoch forms from ``rng``, as its epoch functions form
    them (permutation wrapped to whole batches, rejection negatives)."""
    arrays = jax_data.train_arrays()
    n = len(arrays.users)
    num_batches = -(-n // batch_size)
    padded = num_batches * batch_size
    _, perm_key, k_neg, _ = jax.random.split(rng, 4)
    order = jax_padded_order(jax.random.permutation(perm_key, n), padded)
    users = jnp.asarray(arrays.users)[order]
    neg = jax_make_negative_sampler(jax_data)(k_neg, users, (padded,))
    shape = (num_batches, batch_size)
    return tuple(np.array(x).reshape(shape) for x in (users, jnp.asarray(arrays.items)[order], neg))


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_padded_order_wraps_like_jax():
    perm = np.random.default_rng(0).permutation(7)
    for padded in (7, 9, 16):
        np.testing.assert_array_equal(_padded_order(torch.from_numpy(perm), padded).numpy(),
                                      np.asarray(jax_padded_order(jnp.asarray(perm), padded)))


def test_dense_epoch_matches_jax(split):
    data, jax_data = _both_data(split)
    cfg, ref, params, ours = _models(data)
    rng = jax.random.key(3)
    opt = optax.adam(LR)
    jax_epoch = jax_make_epoch_fn(ref, opt, jax_data.train_arrays(), BATCH,
                                  neg_sampler=jax_make_negative_sampler(jax_data), donate=False)
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)

    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = make_epoch_fn(ours, optimizer, data.train_arrays(), BATCH, make_negative_sampler(data, device="cpu"))
    loss = trainer.run_batches(*jax_epoch_batches(rng, jax_data, BATCH))
    _close(loss, want_loss)
    for name, p in ours.named_parameters():
        _close(p, want_params[name])
        _close(optimizer.state[p]["exp_avg"], want_state[0].mu[name])
        _close(optimizer.state[p]["exp_avg_sq"], want_state[0].nu[name])
        assert int(optimizer.state[p]["step"]) == int(want_state[0].count) == trainer.num_batches


@pytest.mark.parametrize("row_update", ["xla", "fused"])
def test_sparse_epochs_match_jax_and_carry_the_step_count(split, row_update):
    data, jax_data = _both_data(split)
    cfg, ref, params, ours = _models(data)
    tables = list(ref.row_tables())
    opt = optax.adam(LR)
    jax_epoch = jax_make_sparse_epoch_fn(ref, jax_data.train_arrays(), BATCH, jax_make_negative_sampler(jax_data),
                                         LR, dense_optimizer=opt, donate=False, row_update=row_update)
    jax_state = (jax_init_sparse_state(params, tables), opt.init({"global_bias": params["global_bias"]}))

    dense = [p for name, p in ours.named_parameters() if name not in tables]
    trainer = SparseEpochTrainer(ours, data.train_arrays(), BATCH, make_negative_sampler(data, device="cpu"), LR,
                                 make_optimizer(cfg, dense), row_update=row_update)
    rng = jax.random.key(5)
    for epoch in (1, 2):
        batches = jax_epoch_batches(rng, jax_data, BATCH)
        params, jax_state, rng, want_loss = jax_epoch(params, jax_state, rng)
        _close(trainer.run_batches(*batches), want_loss)
        assert trainer.state["step"] == int(jax_state[0]["step"]) == epoch * trainer.num_batches
        for name, p in ours.named_parameters():
            _close(p, params[name])
        for name in tables:
            for got, want in zip(trainer.state["moments"][name], jax_state[0]["moments"][name]):
                _close(got, want)


def test_auto_row_update_is_xla_on_the_cpu(split):
    """Off the card "auto" takes the JAX package's own off-TPU route; on the
    card it takes the kernel (tests/test_torch_rowadam_cuda.py)."""
    data, _ = _both_data(split)
    _, _, _, ours = _models(data)
    trainer = SparseEpochTrainer(ours, data.train_arrays(), BATCH, None, LR, None, row_update="auto")
    assert trainer.row_update == "xla"


def test_tpu_row_layouts_and_other_batch_kinds_raise(split):
    """The JAX package's packed row layouts train (one step each here; held
    to the JAX package in tests/test_torch_row_layouts.py); an unknown
    ``row_update`` raises."""
    data, _ = _both_data(split)
    cfg, _, _, ours = _models(data)
    tables = ours.row_tables()
    gen = torch.Generator().manual_seed(0)
    for layout in ("unified", "compact", "unified_bf16"):
        dense = [p for name, p in ours.named_parameters() if name not in tables]
        trainer = SparseEpochTrainer(ours, data.train_arrays(), BATCH, None, LR, make_optimizer(cfg, dense),
                                     row_update=layout)
        before = ours.item_emb.detach().clone()
        users, pos, neg = (torch.randint(0, n, (BATCH,), generator=gen)
                           for n in (data.n_users, data.n_items, data.n_items))
        assert torch.isfinite(trainer.step(users, pos, neg)) and trainer.state["step"] == 1
        assert not torch.equal(ours.item_emb.detach(), before) and trainer._packed is None
    with pytest.raises(ValueError, match="unknown row_update 'pallas'"):
        SparseEpochTrainer(ours, data.train_arrays(), BATCH, None, LR, None, row_update="pallas")
    # MF + BCE is pointwise and trains (tests/test_torch_train_pointwise.py),
    # multineg batches and rmsprop too (tests/test_torch_train_multineg.py);
    # a batch kind or an optimizer the JAX package lacks raises as it does there.
    with pytest.raises(ValueError, match="got none"):
        make_epoch_fn(types.SimpleNamespace(batch_kind="none"), None, data.train_arrays(), BATCH, None)
    with pytest.raises(ValueError, match="Unknown optimizer adagrad"):
        make_optimizer({"optimizer": "adagrad"}, ours.parameters())


def _config(root, **model):
    return {
        "system": {"root_dir": str(root), "metrics": ["ndcg", "recall"], "k": [5, 10], "valid_metric": "ndcg",
                   "valid_k": 10, "seed": 42, "result_file": "mf_test.csv", "save_last_every": 5},
        "dataset": {"dataset": "synthetic", "data_split": "leave_one_out"},
        "model": {"model": "MF", "emb_dim": 16, "batch_size": 128, "loss": "bpr", "optimizer": "adam",
                  "lr": 0.05, "reg": 0.0, "max_epoch": 30, "max_n_update": 10, **model},
    }


@pytest.mark.parametrize("model", [{}, {"sparse_optim": True, "row_update": "fused"}], ids=["dense", "sparse_fused"])
def test_training_learns_and_the_jax_package_loads_the_checkpoint(split, tmp_path, model):
    data, jax_data = _both_data(split)
    rec = MatrixFactorization(Config(_config(tmp_path / "port", **model)), device="cpu")
    result = rec.train(data)
    ours = rec.test()
    # Random ranking over 21 candidates gives ndcg@10 ~0.20; the ceiling is
    # ~0.5 (four other liked-but-unseen candidates compete).
    assert result["valid_metric"] > 0.35 and ours["ndcg@10"] > 0.35, (result, ours)
    ckpt = result["model_save_dir"]
    meta = load_metadata(ckpt)
    assert meta["kind"] == "best" and meta["best_epoch"] == result["best_epoch"]
    assert set(meta) == {"kind", "best_valid_performance", "best_epoch", "n_no_update", "epoch",
                         "model_run_id", "n_users", "n_items", "config"}
    assert load_metadata(os.path.join(ckpt, "last"))["kind"] == "last"
    raw = load_raw_checkpoint(ckpt)
    assert raw["opt_state"]["0"]["count"] > 0 and set(raw["opt_state"]["0"]["mu"]) == set(raw["params"])

    jax_cfg = JaxConfig(json.loads(json.dumps(_config(tmp_path / "jax", **model))))
    ref = JaxMatrixFactorization(jax_cfg).load(ckpt, jax_data)
    want = ref.test()
    assert list(ours) == sorted(want)
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    users = np.arange(10)
    got_rec = rec.recommend(users=users, k=5)
    want_rec = ref.recommend(users=users, k=5)
    np.testing.assert_array_equal(got_rec[DEFAULT_ITEM_COL], want_rec[DEFAULT_ITEM_COL].to_numpy())
