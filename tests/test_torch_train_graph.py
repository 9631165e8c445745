"""LightGCN and NGCF training in the port against the JAX package: one epoch
of the dense pairwise trainer on batches the JAX code formed against the JAX
epoch function (dropout off, dense and sparse routes), the epoch's generator
reaching every step's loss, and end to end ``LightGCN(cfg, device="cpu")``
and ``NGCF(cfg, device="cpu")`` trained with their dropouts, whose best
checkpoints the JAX package loads and scores to the port's numbers, a seed
repeating bit for bit, and a mesh of several devices refused."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from test_torch_train_mf import jax_epoch_batches, structured_split

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.train_engine import make_epoch_fn as jax_make_epoch_fn
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.models.lightgcn import LightGCN as JaxLightGCNModel
from beta_recsys_tpu.models.ngcf import NGCF as JaxNGCFModel
from beta_recsys_tpu.recommenders import NGCF as JaxNGCF
from beta_recsys_tpu.recommenders import LightGCN as JaxLightGCN
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.core.checkpoint import load_raw_checkpoint
from beta_recsys_tpu_torch.core.train_engine import (
    DenseEpochTrainer,
    make_epoch_fn,
    make_negative_sampler,
    make_optimizer,
)
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.models import build_model
from beta_recsys_tpu_torch.recommenders import NGCF, LightGCN
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_USER_COL

# float32 Adam over a few steps, the propagations' sums in other orders on the
# two sides: a few ulp a step.
TOL = 1e-5
BATCH, LR = 128, 0.01
MODELS = {"LightGCN": (JaxLightGCNModel, "row_selfloop", {"keep_pro": 1.0}),
          "NGCF": (JaxNGCFModel, "row", {"mess_dropout": [0.0, 0.0]})}
RECOMMENDERS = {"LightGCN": (LightGCN, JaxLightGCN), "NGCF": (NGCF, JaxNGCF)}


@pytest.fixture(scope="module")
def split():
    return structured_split()


def _both_data(split):
    train, valid, test = split
    return BaseData(split), JaxBaseData((pd.DataFrame(train), [pd.DataFrame(f) for f in valid],
                                         [pd.DataFrame(f) for f in test]))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("fmt", ["dense", "chunked"])
@pytest.mark.parametrize("name", list(MODELS))
def test_pairwise_epoch_matches_jax(split, name, fmt):
    """One epoch of 3 Adam steps (B 128) on the batches the JAX epoch forms,
    against the JAX epoch function: the loss, every parameter and Adam's
    moments."""
    data, jax_data = _both_data(split)
    jax_cls, variant, no_dropout = MODELS[name]
    cfg = {"model": name, "emb_dim": 16, "layer_size": [16, 16], "regs": [1e-3], "lr": LR, "optimizer": "adam",
           "graph_format": fmt, **no_dropout}
    artifacts = {"adj": data.get_norm_adj(variant)}
    ref = jax_cls(cfg, data.n_users, data.n_items, artifacts)
    params = ref.init_params(jax.random.key(0))
    ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))

    rng = jax.random.key(3)
    opt = optax.adam(LR)
    jax_epoch = jax_make_epoch_fn(ref, opt, jax_data.train_arrays(), BATCH,
                                  neg_sampler=jax_make_negative_sampler(jax_data), donate=False)
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)
    want_params = flatten_params(jax.tree_util.tree_map(np.asarray, want_params))
    want_mu = flatten_params(jax.tree_util.tree_map(np.asarray, want_state[0].mu))
    want_nu = flatten_params(jax.tree_util.tree_map(np.asarray, want_state[0].nu))

    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = make_epoch_fn(ours, optimizer, data.train_arrays(), BATCH, make_negative_sampler(data, device="cpu"))
    assert isinstance(trainer, DenseEpochTrainer) and trainer.num_batches == 3
    _close(trainer.run_batches(*jax_epoch_batches(rng, jax_data, BATCH), generator=torch.Generator()), want_loss)
    for pname, p in ours.named_parameters():
        _close(p, want_params[pname], pname)
        _close(optimizer.state[p]["exp_avg"], want_mu[pname], pname)
        _close(optimizer.state[p]["exp_avg_sq"], want_nu[pname], pname)
        assert int(optimizer.state[p]["step"]) == int(want_state[0].count) == 3


class _Recorder:
    """A model stand-in whose loss keeps each step's batch and generator."""

    batch_kind = "pairwise"

    def __init__(self):
        self.weight = torch.nn.Parameter(torch.zeros(()))
        self.calls = []

    def parameters(self):
        return iter([self.weight])

    def loss(self, batch, generator=None):
        self.calls.append((batch, generator))
        return self.weight * 0.0 + batch["users"].float().mean()


def test_each_step_gets_the_epochs_generator(split):
    data, _ = _both_data(split)
    model = _Recorder()
    trainer = DenseEpochTrainer(model, torch.optim.SGD(model.parameters(), lr=0.0), data.train_arrays(), BATCH,
                                make_negative_sampler(data, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    users, pos, neg = trainer.form(torch.Generator().manual_seed(1))
    trainer.run(gen)
    assert len(model.calls) == trainer.num_batches and all(g is gen for _, g in model.calls)
    model.calls.clear()
    trainer.run_batches(users, pos, neg)
    assert [g for _, g in model.calls] == [None] * trainer.num_batches
    for b, (batch, _) in enumerate(model.calls):
        assert torch.equal(batch["users"], users[b]) and torch.equal(batch["neg_items"], neg[b])


def _config(root, name, seed=3, **model):
    return {
        "system": {"root_dir": str(root), "metrics": ["ndcg", "recall"], "k": [5, 10], "valid_metric": "ndcg",
                   "valid_k": 10, "seed": seed, "result_file": f"{name}_test.csv", "save_last_every": 4},
        "dataset": {"dataset": "synthetic", "data_split": "leave_one_out"},
        "model": {"model": name, "emb_dim": 16, "layer_size": [16, 16], "keep_pro": 0.6,
                  "mess_dropout": [0.1, 0.1], "regs": [1e-4], "adj_variant": "row_selfloop", "batch_size": 64,
                  "optimizer": "adam", "lr": 0.01, "max_epoch": 8, "max_n_update": 6, **model},
    }


@pytest.fixture(scope="module")
def trained(split, tmp_path_factory):
    data, _ = _both_data(split)
    out = {}
    for name, (cls, _) in RECOMMENDERS.items():
        rec = cls(Config(_config(tmp_path_factory.mktemp(name), name)), device="cpu")
        out[name] = (rec, rec.train(data), rec.test())
    return out


@pytest.mark.parametrize("name", list(RECOMMENDERS))
def test_training_learns_and_the_jax_package_loads_the_checkpoint(split, trained, tmp_path, name):
    data, jax_data = _both_data(split)
    rec, result, ours = trained[name]
    # Random ranking over 21 candidates gives ndcg@10 ~0.20.
    assert result["valid_metric"] > 0.3 and ours["ndcg@10"] > 0.3, (result, ours)
    raw = load_raw_checkpoint(result["model_save_dir"])
    assert raw["opt_state"]["0"]["count"] > 0
    assert set(flatten_params(raw["opt_state"]["0"]["mu"])) == set(flatten_params(raw["params"]))

    jax_cfg = JaxConfig(json.loads(json.dumps(_config(tmp_path / "jax", name))))
    ref = RECOMMENDERS[name][1](jax_cfg).load(result["model_save_dir"], jax_data)
    frame = {c: data.test[0][c][:150] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    np.testing.assert_allclose(rec.predict(frame), np.asarray(ref.predict(ref.data.test[0].iloc[:150])),
                               rtol=1e-5, atol=1e-6)
    want = ref.test()
    assert list(ours) == sorted(want)
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", list(RECOMMENDERS))
def test_a_seed_repeats_bit_for_bit(split, tmp_path, name):
    """Two trainings of one seed, dropout on, give the same best model and
    epoch. On one thread: the CPU's kernels may split a sum over threads in
    another order on another run."""
    data, _ = _both_data(split)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = []
        for _ in range(2):
            rec = RECOMMENDERS[name][0](Config(_config(tmp_path, name, max_epoch=3)), device="cpu")
            runs.append((rec.train(data), rec.model.state_dict(), rec.engine.bookkeeper.history))
    finally:
        torch.set_num_threads(threads)
    (first, first_state, first_history), (again, again_state, again_history) = runs
    assert (again["best_epoch"], again["valid_metric"]) == (first["best_epoch"], first["valid_metric"])
    assert again_history == first_history
    for key, value in first_state.items():
        assert torch.equal(again_state[key], value), key


def test_a_mesh_of_several_devices_raises(split, tmp_path):
    """LightGCN trains an epoch on a (2, 1) mesh (each data shard's
    propagation and loss, one all-reduce a step)."""
    data, _ = _both_data(split)
    cfg = Config(_config(tmp_path, "LightGCN", max_epoch=1)).replace(system={"mesh": {"data": 2, "model": 1}})
    rec = LightGCN(cfg, device="cpu", mesh_devices=["cpu"] * 2)
    result = rec.train(data)
    assert rec.engine.epoch_fn.dp.mode == "data" and len(rec.engine.bookkeeper.history) == 1
    assert np.isfinite(result["valid_metric"])
