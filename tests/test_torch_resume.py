"""Full-state resume: within the port, 2 epochs then ``resume_training`` for
2 more repeat 4 straight epochs bit for bit (parameters, optimizer state,
step, bookkeeper, generator) for Adam, rmsprop, sgd and lazy Adam (both row
updates); the JAX package's ``last/`` resumes into the state its own
``resume_training`` gives, and stops after one epoch as it does; the JAX
package resumes a ``last/`` the port wrote; a mesh raises; and
``system.profile`` writes a trace."""

import json
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.train_engine import TrainEngine as JaxTrainEngine
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.models import build_model as jax_build_model
from beta_recsys_tpu_torch.config import Config, load_config
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.core.checkpoint import load_metadata, load_raw_checkpoint
from beta_recsys_tpu_torch.core.train_engine import TrainEngine
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.models import build_model
from test_torch_train_mf import structured_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
MF_CHECKPOINT = os.path.join(REPO, "parity_runs/checkpoints/MF_default_20260821_134231_aaquvl")


@pytest.fixture(scope="module")
def split():
    return structured_split()


def _config(root, **model):
    return Config({"model": {"model": "MF", "emb_dim": 8, "lr": 0.05, "batch_size": 64, "max_epoch": 4, **model},
                   "system": {"root_dir": str(root), "seed": 3}, "dataset": {}})


def _engine(cfg, data):
    model = build_model(cfg.model, data.n_users, data.n_items, {}, "cpu")
    return TrainEngine(cfg, "cpu").build(model, data, data.eval_candidates(data.valid[0]),
                                         data.eval_candidates(data.test[0]))


def _state(engine):
    """Everything a run carries from epoch to epoch."""
    out = {f"param/{k}": v.clone() for k, v in engine.model.state_dict().items()}
    for p, st in engine.optimizer.state.items():
        for key, value in st.items():
            out[f"opt/{engine.names[id(p)]}/{key}"] = torch.as_tensor(value).clone()
    if engine.sparse_optim:
        out["sparse/step"] = torch.tensor(engine.epoch_fn.state["step"])
        for name, (m, v) in engine.epoch_fn.state["moments"].items():
            out[f"sparse/{name}/m"], out[f"sparse/{name}/v"] = m.clone(), v.clone()
    out["generator"] = engine.generator.get_state()
    bk = engine.bookkeeper
    out["bookkeeper"] = torch.tensor([bk.best_valid_performance, bk.best_epoch, bk.n_no_update], dtype=torch.float64)
    return out


OPTIMIZERS = {
    "adam": {"optimizer": "adam"},
    "rmsprop": {"optimizer": "rmsprop", "lr": 0.01},
    "sgd": {"optimizer": "sgd", "lr": 0.5},
    "lazy-adam-xla": {"optimizer": "adam", "sparse_optim": True, "row_update": "xla"},
    "lazy-adam-fused": {"optimizer": "adam", "sparse_optim": True, "row_update": "fused"},
}


@pytest.fixture
def one_thread():
    """One thread: the CPU's sums run in one order in every run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_resume_repeats_an_uninterrupted_run_bit_for_bit(name, split, tmp_path, one_thread):
    data = BaseData(split)
    cfg = _config(tmp_path, **OPTIMIZERS[name])
    first = _engine(cfg, data)
    first.train(max_epoch=2, verbose=False)
    resumed = _engine(cfg, data)
    assert resumed.resume_training(first.checkpoint_dir) == 2
    resumed.train(verbose=False)
    straight = _engine(cfg, data)
    straight.train(verbose=False)
    assert resumed.start_epoch == 0  # a finished train() uses the resume point up
    for engine in (resumed, straight):
        engine.names = {id(p): n for n, p in engine.model.named_parameters()}
    got, want = _state(resumed), _state(straight)
    assert list(got) == list(want)
    if name != "sgd":
        assert any(key.startswith(("opt/", "sparse/")) for key in want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert [h["epoch"] for h in resumed.bookkeeper.history] == [2, 3]
    last = load_metadata(os.path.join(resumed.checkpoint_dir, "last"))
    assert last["epoch"] == 3


def _jax_engine(raw_cfg, jax_data):
    cfg = JaxConfig(raw_cfg)
    model = jax_build_model(cfg.model, jax_data.n_users, jax_data.n_items)
    return JaxTrainEngine(cfg).build(model, jax_data, jax_data.eval_candidates(jax_data.valid[0]))


def _jax_opt_tree(opt_state):
    """The JAX engine's optax state as the checkpoint's tree."""
    from flax import serialization

    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(opt_state))


def test_jax_last_checkpoint_resumes_as_in_jax(tmp_path):
    """The MF checkpoint's ``last/`` (epoch 33, 20 epochs without a gain):
    the port restores the JAX engine's state bit for bit, seeds its
    generator from the key data, and stops after one epoch, as JAX does."""
    raw = load_metadata(MF_CHECKPOINT)["config"]
    raw["system"]["root_dir"] = str(tmp_path / "jax")
    ref = _jax_engine(raw, JaxBaseData(jax_load_split_data(SPLIT, n_test=1)))
    cfg = load_config(MF_CHECKPOINT).replace(system={"root_dir": str(tmp_path / "port")})
    data = BaseData(load_split_data(SPLIT, n_test=1))
    ours = TrainEngine(cfg, "cpu").build(build_model(cfg.model, data.n_users, data.n_items, {}, "cpu"), data,
                                         data.eval_candidates(data.valid[0]))
    assert ours.resume_training(MF_CHECKPOINT) == ref.resume_training(MF_CHECKPOINT) == 34
    assert not ours.sparse_optim
    for key, value in flatten_params(jax.tree_util.tree_map(np.asarray, ref.params)).items():
        assert torch.equal(ours.model.state_dict()[key], value), key
    want = _jax_opt_tree(ref.opt_state)["0"]
    names = {id(p): n for n, p in ours.model.named_parameters()}
    for p, st in ours.optimizer.state.items():
        name = names[id(p)]
        assert int(st["step"]) == int(want["count"]) == 8364
        np.testing.assert_array_equal(st["exp_avg"].numpy(), want["mu"][name])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), want["nu"][name])
    for attr in ("best_valid_performance", "best_epoch", "n_no_update"):
        assert getattr(ours.bookkeeper, attr) == getattr(ref.bookkeeper, attr), attr
    key = load_raw_checkpoint(os.path.join(MF_CHECKPOINT, "last"))["rng"]
    assert ours.generator.initial_seed() == (int(key[0]) << 32) | int(key[1])
    ours.train(verbose=False)
    ref.train(verbose=False)
    assert [h["epoch"] for h in ours.bookkeeper.history] == [h["epoch"] for h in ref.bookkeeper.history] == [34]
    assert ours.bookkeeper.n_no_update == ref.bookkeeper.n_no_update == 21


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop", "sgd"])
def test_jax_resumes_a_port_last_checkpoint(optimizer, split, tmp_path):
    data = BaseData(split)
    cfg = _config(tmp_path / "port", optimizer=optimizer)
    ours = _engine(cfg, data)
    ours.train(max_epoch=2, verbose=False)
    raw = cfg.to_dict()
    raw["system"]["root_dir"] = str(tmp_path / "jax")
    train, valid, test = split
    jax_data = JaxBaseData((pd.DataFrame(train), [pd.DataFrame(f) for f in valid], [pd.DataFrame(f) for f in test]))
    ref = _jax_engine(raw, jax_data)
    assert ref.resume_training(ours.checkpoint_dir) == 2
    for key, value in flatten_params(jax.tree_util.tree_map(np.asarray, ref.params)).items():
        assert torch.equal(ours.model.state_dict()[key], value), key
    want = load_raw_checkpoint(os.path.join(ours.checkpoint_dir, "last"))["opt_state"]
    got = _jax_opt_tree(ref.opt_state)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert ref.bookkeeper.best_epoch == ours.bookkeeper.best_epoch
    ref.train(max_epoch=3, verbose=False)
    assert [h["epoch"] for h in ref.bookkeeper.history] == [2]


def test_resume_on_a_mesh_raises(split, tmp_path):
    """A (1, 2) row-sharded sparse run's last/ resumed on the mesh: the
    tables' shards, their moments and the step the run ended with."""
    data = BaseData(split)
    cfg = _config(tmp_path, sparse_optim=True, max_epoch=1).replace(system={"mesh": {"data": 1, "model": 2}})

    def engine():
        model = build_model(cfg.model, data.n_users, data.n_items, {}, "cpu")
        return TrainEngine(cfg, "cpu", mesh_devices=["cpu"] * 2).build(model, data)

    first = engine()
    first.train(verbose=False)
    resumed = engine()
    assert resumed.resume_training(first.checkpoint_dir) == 1
    for name, shards in first.epoch_fn.tables.items():
        for want, got in zip(shards[0], resumed.epoch_fn.tables[name][0]):
            assert torch.equal(want, got), name
    for name, (m, v) in first.epoch_fn.state["moments"].items():
        assert torch.equal(m, resumed.epoch_fn.state["moments"][name][0]), name
        assert torch.equal(v, resumed.epoch_fn.state["moments"][name][1]), name
    assert resumed.epoch_fn.step_count == first.epoch_fn.step_count > 0


def test_profile_writes_a_trace_of_epochs_0_and_1(split, tmp_path):
    data = BaseData(split)
    cfg = _config(tmp_path, max_epoch=3).replace(system={"profile": True})
    engine = _engine(cfg, data)
    engine.train(verbose=False)
    path = os.path.join(str(tmp_path), "runs", engine.model_run_id, "profile", "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert events and any("aten::" in str(e.get("name", "")) for e in events)
    assert engine.profile_dir == path.rsplit(os.sep, 1)[0]
