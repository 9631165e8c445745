"""The sequence_time (TiSASRec), prefix (NARM) and userrow (VAECF) trainers
of the port against the JAX package at a small size: one epoch of each
through ``run_batches`` on the orders and draws the JAX epoch function
forms (dropout 0; VAECF's latent noise handed over), the batches in
distribution, ``XRecommender(cfg, device="cpu").train(data)`` of each model
whose best checkpoint the JAX package loads and tests to the port's
metrics, and a mesh of several devices raising."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from test_torch_train_sasrec import sequence_split

from beta_recsys_tpu import recommenders as jax_recommenders
from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.train_engine import _padded_order as jax_padded_order
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.core.train_engine import make_prefix_epoch_fn as jax_make_prefix_epoch_fn
from beta_recsys_tpu.core.train_engine import make_sequence_time_epoch_fn as jax_make_sequence_time_epoch_fn
from beta_recsys_tpu.core.train_engine import make_userrow_epoch_fn as jax_make_userrow_epoch_fn
from beta_recsys_tpu.data.sequential_data import SequentialData as JaxSequentialData
from beta_recsys_tpu.models.narm import NARM as JaxNARM
from beta_recsys_tpu.models.tisasrec import TiSASRec as JaxTiSASRec
from beta_recsys_tpu.models.vaecf import VAECF as JaxVAECF
from beta_recsys_tpu_torch import recommenders
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.core.checkpoint import load_raw_checkpoint
from beta_recsys_tpu_torch.core.train_engine import (
    PrefixEpochTrainer,
    SequenceTimeEpochTrainer,
    TrainEngine,
    UserRowEpochTrainer,
    make_negative_sampler,
    make_optimizer,
)
from beta_recsys_tpu_torch.data.sequential_data import SequentialData
from beta_recsys_tpu_torch.models import build_model
from beta_recsys_tpu_torch.models import vaecf as port_vaecf
from beta_recsys_tpu_torch.models.narm import NARM
from beta_recsys_tpu_torch.models.tisasrec import TiSASRec
from beta_recsys_tpu_torch.models.vaecf import VAECF
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL

TOL = 1e-5
MAXLEN, SPAN = 10, 32


@pytest.fixture(scope="module")
def both():
    split = sequence_split()
    train, valid, test = split
    return split, SequentialData(split), JaxSequentialData(
        (pd.DataFrame(train), [pd.DataFrame(f) for f in valid], [pd.DataFrame(f) for f in test]))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=TOL, atol=TOL, err_msg=what)


MODEL_CFG = {
    "TiSASRec": {"model": "TiSASRec", "emb_dim": 16, "num_blocks": 2, "num_heads": 2, "maxlen": MAXLEN,
                 "time_span": SPAN, "dropout_rate": 0.0, "l2_emb": 0.01},
    "NARM": {"model": "NARM", "emb_dim": 12, "hidden_size": 16, "maxlen": MAXLEN, "dropout_input": 0.0,
             "dropout_hidden": 0.0},
    "VAECF": {"model": "VAECF", "z_dim": 4, "ae_structure": [12], "activation": "tanh", "likelihood": "mult"},
}
JAX_MODELS = {"TiSASRec": JaxTiSASRec, "NARM": JaxNARM, "VAECF": JaxVAECF}
PORT_MODELS = {"TiSASRec": TiSASRec, "NARM": NARM, "VAECF": VAECF}


def _models(name, data):
    """The JAX model, its initial params and the port's model on them."""
    cfg = {**MODEL_CFG[name], "lr": 1e-3, "optimizer": "adam"}
    ref = JAX_MODELS[name](cfg, data.n_users, data.n_items)
    params = ref.init_params(jax.random.key(0))
    ours = PORT_MODELS[name](cfg, data.n_users, data.n_items, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    return cfg, ref, params, ours


def _epoch_matches(cfg, ours, optimizer, want_params, want_state, want_loss, loss, steps):
    _close(loss, want_loss, "mean loss")
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want_params))
    for name, p in ours.named_parameters():
        _close(p, want[name], what=name)
        assert int(optimizer.state[p]["step"]) == int(want_state[0].count) == steps


def test_sequence_time_epoch_matches_jax(both):
    """One TiSASRec epoch on the (rows, users, negatives) the JAX
    ``make_sequence_time_epoch_fn`` forms from its key."""
    _, data, jax_data = both
    cfg, ref, params, ours = _models("TiSASRec", data)
    batch_size = 10
    arrays = jax_data.tisasrec_arrays(MAXLEN, SPAN)
    opt = optax.adam(cfg["lr"])
    neg_sampler = jax_make_negative_sampler(jax_data)
    rng = jax.random.key(4)
    n = len(arrays["users"])
    num_batches = n // batch_size
    _, k_row, k_neg, _ = jax.random.split(rng, 4)
    rows = jax.random.randint(k_row, (num_batches, batch_size), 0, n)
    users = jnp.asarray(arrays["users"])[rows]
    neg0 = neg_sampler(k_neg, users[..., None], (num_batches, batch_size, MAXLEN))
    jax_epoch = jax_make_sequence_time_epoch_fn(ref, opt, arrays, batch_size, neg_sampler, donate=False)
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)

    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = SequenceTimeEpochTrainer(ours, optimizer, data.tisasrec_arrays(MAXLEN, SPAN), batch_size,
                                       make_negative_sampler(data, device="cpu"))
    assert trainer.num_batches == num_batches == 3
    loss = trainer.run_batches(*(np.array(x) for x in (rows, users, neg0)))
    _epoch_matches(cfg, ours, optimizer, want_params, want_state, want_loss, loss, num_batches)


def _jax_order(rng, n, batch_size):
    """The (num_batches, B) order a JAX permutation epoch forms from ``rng``."""
    num_batches = -(-n // batch_size)
    _, perm_key, k_epoch = jax.random.split(rng, 3)
    order = jax_padded_order(jax.random.permutation(perm_key, n), num_batches * batch_size)
    return np.array(order.reshape(num_batches, batch_size)), jax.random.split(k_epoch, num_batches)


def test_prefix_epoch_matches_jax(both):
    """One NARM epoch on the wrapped permutation ``make_prefix_epoch_fn``
    forms from its key (its last batch repeats the permutation's head)."""
    _, data, jax_data = both
    cfg, ref, params, ours = _models("NARM", data)
    batch_size = 64
    arrays = jax_data.prefix_target_arrays(MAXLEN)
    n = len(arrays["target"])
    assert n % batch_size  # the wrap is exercised
    opt = optax.adam(cfg["lr"])
    rng = jax.random.key(5)
    order, _ = _jax_order(rng, n, batch_size)
    jax_epoch = jax_make_prefix_epoch_fn(ref, opt, arrays, batch_size, donate=False)
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)

    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = PrefixEpochTrainer(ours, optimizer, data.prefix_target_arrays(MAXLEN), batch_size)
    assert (trainer.num_batches, trainer.batch_size) == order.shape
    loss = trainer.run_batches(order)
    _epoch_matches(cfg, ours, optimizer, want_params, want_state, want_loss, loss, order.shape[0])


def test_userrow_epoch_matches_jax(both, monkeypatch):
    """One VAECF epoch on the order ``make_userrow_epoch_fn`` forms from its
    key, each step's latent noise the JAX step's draw from its own key."""
    _, data, jax_data = both
    cfg, ref, params, ours = _models("VAECF", data)
    batch_size = 16
    rows = (np.asarray(jax_data.user_item_csr().todense()) > 0).astype(np.float32)
    opt = optax.adam(cfg["lr"])
    rng = jax.random.key(6)
    order, keys = _jax_order(rng, data.n_users, batch_size)
    noise = [np.array(jax.random.normal(k, (batch_size, cfg["z_dim"]))) for k in keys]
    jax_epoch = jax_make_userrow_epoch_fn(ref, opt, rows, batch_size, donate=False)
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)

    monkeypatch.setattr(port_vaecf, "latent_noise", lambda generator, shape, device: torch.from_numpy(noise.pop(0)))
    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = UserRowEpochTrainer(ours, optimizer, (data.user_item_csr().toarray() > 0).astype(np.float32),
                                  batch_size)
    loss = trainer.run_batches(order, generator=torch.Generator().manual_seed(0))
    assert not noise
    _epoch_matches(cfg, ours, optimizer, want_params, want_state, want_loss, loss, order.shape[0])


@pytest.mark.parametrize("kind", ["prefix", "userrow"])
def test_permutation_orders_cover_every_example_once_and_wrap_their_head(both, kind):
    """Each epoch's order is a permutation of the examples wrapped to
    ceil(n / B) batches (the wrap repeats its head), and a position holds
    each example about equally often over epochs."""
    _, data, _ = both
    _, _, _, ours = _models("NARM" if kind == "prefix" else "VAECF", data)
    if kind == "prefix":
        trainer = PrefixEpochTrainer(ours, None, data.prefix_target_arrays(MAXLEN), 64)
    else:
        trainer = UserRowEpochTrainer(ours, None, np.zeros((data.n_users, data.n_items), np.float32), 16)
    n, gen = trainer.n, torch.Generator().manual_seed(0)
    assert n % trainer.batch_size and trainer.num_batches == -(-n // trainer.batch_size)
    epochs, firsts = 400, []
    for _ in range(epochs):
        (order,) = trainer.form(gen)
        assert order.shape == (trainer.num_batches, trainer.batch_size)
        flat = order.reshape(-1)
        assert torch.equal(torch.sort(flat[:n]).values, torch.arange(n))
        assert torch.equal(flat[n:], flat[: trainer.padded_size - n])
        firsts.append(flat[0])
    counts = np.bincount(torch.stack(firsts).numpy(), minlength=n)
    expected = epochs / n
    assert np.abs(counts - expected).max() <= 5 * np.sqrt(expected) + 1


def test_batches_carry_each_kinds_arrays(both):
    """A sequence_time batch carries its rows' interval matrices, a prefix
    batch its examples' prefixes and targets, a userrow batch its users'
    rows and ids."""
    _, data, _ = both
    arrays = data.tisasrec_arrays(MAXLEN, SPAN)
    _, _, _, tis = _models("TiSASRec", data)
    trainer = SequenceTimeEpochTrainer(tis, None, arrays, 8, make_negative_sampler(data, device="cpu"))
    rows, users, neg0 = trainer.form(torch.Generator().manual_seed(1))
    batch = trainer.batch(rows[0], users[0], neg0[0])
    r = rows[0].numpy()
    assert np.array_equal(batch["time_matrix"].numpy(), arrays["time_matrix"][r])
    assert np.array_equal(batch["seq"].numpy(), arrays["seq"][r])
    assert np.array_equal(batch["neg"].numpy() == 0, arrays["pos"][r] == 0)
    prefix = data.prefix_target_arrays(MAXLEN)
    _, _, _, narm = _models("NARM", data)
    order = torch.tensor([3, 0, 7])
    batch = PrefixEpochTrainer(narm, None, prefix, 4).batch(order)
    assert np.array_equal(batch["seq"].numpy(), prefix["seq"][[3, 0, 7]])
    assert np.array_equal(batch["target"].numpy(), prefix["target"][[3, 0, 7]])
    _, _, _, vae = _models("VAECF", data)
    user_rows = np.random.default_rng(0).random((data.n_users, data.n_items)).astype(np.float32)
    batch = UserRowEpochTrainer(vae, None, user_rows, 4).batch(order)
    assert np.array_equal(batch["rows"].numpy(), user_rows[[3, 0, 7]]) and torch.equal(batch["users"], order)


def _config(root, name, **model):
    return {
        "system": {"root_dir": str(root), "metrics": ["ndcg", "recall"], "k": [5, 10], "valid_metric": "ndcg",
                   "valid_k": 10, "seed": 7, "result_file": f"{name}_test.csv", "save_last_every": 2},
        "dataset": {"dataset": "synthetic", "data_split": "leave_one_out"},
        "model": {**MODEL_CFG[name], "batch_size": 16, "optimizer": "adam", "lr": 0.01, "max_epoch": 3,
                  "max_n_update": 10, **model},
    }


TRAINED = {
    "TiSASRec": {"dropout_rate": 0.2},
    "NARM": {"dropout_input": 0.25, "dropout_hidden": 0.5},
    "VAECF": {"batch_size": 8},
}


@pytest.mark.parametrize("name", list(TRAINED))
def test_training_runs_and_the_jax_package_loads_the_checkpoint(both, tmp_path, name):
    """``XRecommender(cfg, device="cpu").train(data)``: the epochs, the
    best checkpoint with Adam's state in the JAX layout, and the JAX
    package's load() of it giving the port's test() and top-5 lists."""
    split, data, jax_data = both
    cls = getattr(recommenders, name)
    rec = cls(Config(_config(tmp_path / "port", name, **TRAINED[name])), device="cpu")
    result = rec.train(SequentialData(split) if cls.data_class is SequentialData else cls.data_class(split))
    ours = rec.test()
    assert len(rec.engine.bookkeeper.history) == 3 and 0 <= result["best_epoch"] < 3
    assert np.isfinite(result["valid_metric"]) and result["valid_metric"] > 0
    raw = load_raw_checkpoint(result["model_save_dir"])
    assert set(raw["opt_state"]["0"]["mu"]) == set(raw["params"])
    assert int(raw["opt_state"]["0"]["count"]) == (result["best_epoch"] + 1) * rec.engine.epoch_fn.num_batches

    jax_cls = getattr(jax_recommenders, name)
    ref_data = jax_data if jax_cls.data_class is JaxSequentialData else jax_cls.data_class(
        tuple(pd.DataFrame(p) if isinstance(p, dict) else [pd.DataFrame(f) for f in p] for p in split))
    ref = jax_cls(JaxConfig(json.loads(json.dumps(_config(tmp_path / "jax", name, **TRAINED[name]))))).load(
        result["model_save_dir"], ref_data)
    want = ref.test()
    assert list(ours) == sorted(want)
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    users = np.arange(10)
    got_rec, want_rec = rec.recommend(users=users, k=5), ref.recommend(users=users, k=5)
    np.testing.assert_array_equal(got_rec[DEFAULT_ITEM_COL], want_rec[DEFAULT_ITEM_COL].to_numpy())
    assert os.path.exists(os.path.join(result["model_save_dir"], "last", "checkpoint.msgpack"))


@pytest.mark.parametrize("name", list(MODEL_CFG))
def test_a_mesh_of_several_devices_raises(both, tmp_path, name):
    """Each model builds and trains an epoch on a (2, 1) mesh."""
    _, data, _ = both
    cfg = Config(_config(tmp_path, name, batch_size=15)).replace(system={"mesh": {"data": 2, "model": 1}})
    model = build_model(cfg.model, data.n_users, data.n_items, device="cpu")
    engine = TrainEngine(cfg, "cpu", mesh_devices=["cpu"] * 2).build(model, data)
    assert engine.epoch_fn.dp.mode == "data" and engine.epoch_fn.batch_size == 14
    engine.train(max_epoch=1, verbose=False)
    assert engine.has_checkpoint("last") and all(torch.isfinite(p).all() for p in model.parameters())
