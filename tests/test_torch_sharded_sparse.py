"""Row-sharded MF training in the port against the JAX package: the bucket
compaction, one epoch of ``ShardedSparseEpochTrainer`` on JAX-formed batches
against ``make_sharded_sparse_epoch_fn`` (its "psum" lookup: the JAX
package's own tests hold "ring" equal to it within capacity, and its
interpret-mode ring inside an epoch costs tens of minutes on the CPU), the
overflow count, and end to end ``MatrixFactorization(cfg, device="cpu",
mesh_devices=["cpu"] * n)`` with ``system.mesh``: it learns, and its padded
checkpoints cross between the packages with equal test metrics."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.sparse_optim import _bucket_by_owner as jax_bucket_by_owner
from beta_recsys_tpu.core.sparse_optim import init_sparse_state as jax_init_sparse_state
from beta_recsys_tpu.core.sparse_optim import make_sharded_sparse_epoch_fn as jax_make_sharded_sparse_epoch_fn
from beta_recsys_tpu.core.sparse_optim import shard_sparse_params as jax_shard_sparse_params
from beta_recsys_tpu.core.train_engine import _padded_order as jax_padded_order
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.data.base_data import TrainArrays
from beta_recsys_tpu.datasets.data_split import feed_neg_sample, leave_one_out
from beta_recsys_tpu.recommenders import MatrixFactorization as JaxMatrixFactorization
from beta_recsys_tpu.utils.alias_table import AliasTable
from beta_recsys_tpu.utils.constants import DEFAULT_FLAG_COL, DEFAULT_ITEM_COL
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.core import train_engine
from beta_recsys_tpu_torch.core.checkpoint import load_raw_checkpoint
from beta_recsys_tpu_torch.core.sparse_optim import ShardedSparseEpochTrainer, _bucket_by_owner
from beta_recsys_tpu_torch.core.train_engine import make_negative_sampler, make_optimizer
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.models import build_model
from beta_recsys_tpu_torch.parallel.mesh import make_mesh
from beta_recsys_tpu_torch.recommenders import MatrixFactorization
from tests.test_torch_train_mf import BATCH, LR, _both_data, _models, structured_split
from tests.test_train_mf import make_structured_interactions

# One epoch of lazy Adam on both sides, on well-conditioned parameters
# (``_models``): float32 sums in other orders, a few ulp a step.
TOL = 1e-5
MESHES = [(1, 4), (2, 2), (4, 1)]


@pytest.fixture(scope="module")
def split():
    return structured_split()


def _jax_mesh(n_data, n_model):
    return Mesh(np.array(jax.devices()[: n_data * n_model]).reshape(n_data, n_model), ("data", "model"))


def _jax_batches(rng, arrays, neg_sampler, batch_size):
    """The (num_batches, B) batches a JAX sharded epoch forms from ``rng``."""
    n = len(arrays.users)
    num_batches = -(-n // batch_size)
    padded = num_batches * batch_size
    _, perm_key, k_neg, _ = jax.random.split(rng, 4)
    order = jax_padded_order(jax.random.permutation(perm_key, n), padded)
    users = jnp.asarray(arrays.users)[order]
    neg = neg_sampler(k_neg, users, (padded,))
    shape = (num_batches, batch_size)
    return tuple(np.array(x).reshape(shape) for x in (users, jnp.asarray(arrays.items)[order], neg))


def _jax_epoch(ref, params, arrays, neg_sampler, mesh_shape, rng, **kwargs):
    """One JAX sharded epoch: (padded params, sparse state, loss)."""
    mesh = _jax_mesh(*mesh_shape)
    tables = list(ref.row_tables())
    opt = optax.adam(LR)
    fn = jax_make_sharded_sparse_epoch_fn(ref, arrays, BATCH, neg_sampler, lr=LR, mesh=mesh, dense_optimizer=opt,
                                          donate=False, **kwargs)
    placed = jax_shard_sparse_params(params, tables, mesh)
    state = (jax_init_sparse_state(placed, tables), opt.init({"global_bias": placed["global_bias"]}))
    p, s, _, loss = fn(placed, state, rng)
    return jax.tree_util.tree_map(np.asarray, p), jax.tree_util.tree_map(np.asarray, s[0]), float(loss)


_JAX_EPOCHS = {}


def _jax_epoch_for(split, mesh_shape):
    if mesh_shape not in _JAX_EPOCHS:
        data, jax_data = _both_data(split)
        _, ref, params, _ = _models(data)
        _JAX_EPOCHS[mesh_shape] = _jax_epoch(ref, params, jax_data.train_arrays(),
                                             jax_make_negative_sampler(jax_data), mesh_shape, jax.random.key(5))
    return _JAX_EPOCHS[mesh_shape]


def _port_trainer(data, ours, cfg, mesh_shape, arrays=None, **kwargs):
    mesh = make_mesh(*mesh_shape, ["cpu"] * (mesh_shape[0] * mesh_shape[1]))
    return ShardedSparseEpochTrainer(ours, arrays or data.train_arrays(), BATCH,
                                     make_negative_sampler(data, device="cpu"), LR, mesh,
                                     lambda params: make_optimizer(cfg, params), **kwargs)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("capacity", [4, 32])
def test_bucket_by_owner_equals_jax(capacity):
    rng = np.random.default_rng(capacity)
    ids = np.sort(rng.integers(0, 64, 48))
    rows = rng.standard_normal((48, 3)).astype(np.float32)
    rows[::5] = 0.0  # untouched rows never enter a bucket
    for shard in range(4):
        want = jax_bucket_by_owner(jnp.asarray(ids, jnp.int32), jnp.asarray(rows), 4, 16, capacity, shard)
        got = _bucket_by_owner(torch.from_numpy(ids), torch.from_numpy(rows), 4, 16, capacity, shard)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("lookup,exchange", [("psum", "allgather"), ("ring", "bucketed")])
def test_epoch_matches_jax(split, mesh_shape, lookup, exchange):
    """Tables, moments, the dense parameter and the loss after one epoch on
    the JAX batches; the JAX side runs its psum lookup and all-gather
    exchange, which its own tests hold equal to ring and bucketed in
    capacity."""
    want_params, want_state, want_loss = _jax_epoch_for(split, mesh_shape)
    data, jax_data = _both_data(split)
    cfg, _, _, ours = _models(data)
    trainer = _port_trainer(data, ours, cfg, mesh_shape, lookup_strategy=lookup, grad_exchange=exchange)
    loss = trainer.run_batches(*_jax_batches(jax.random.key(5), jax_data.train_arrays(),
                                             jax_make_negative_sampler(jax_data), BATCH))
    _close(loss, want_loss)
    for name, value in trainer.padded_params().items():
        _close(value.detach(), want_params[name])
    state = trainer.state
    assert state["step"] == int(want_state["step"]) == trainer.num_batches
    assert int(state["dropped"]) == int(want_state["dropped"]) == 0
    for name, pair in state["moments"].items():
        for got, want in zip(pair, want_state["moments"][name]):
            _close(got, want)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_ring_equals_psum_and_bucketed_equals_allgather(split, mesh_shape):
    """Within capacity the strategies are one computation. A lookup copies
    rows either way, so "ring" equals "psum" bit for bit. "bucketed" sums a
    row's duplicates within each data shard before it sums across them, so it
    equals "allgather" bit for bit on one data shard and to float32 rounding
    (1e-6) on two."""
    data, jax_data = _both_data(split)
    batches = _jax_batches(jax.random.key(9), jax_data.train_arrays(), jax_make_negative_sampler(jax_data), BATCH)
    results = {}
    for lookup, exchange in [("psum", "allgather"), ("ring", "allgather"), ("psum", "bucketed")]:
        cfg, _, _, ours = _models(data)
        trainer = _port_trainer(data, ours, cfg, mesh_shape, lookup_strategy=lookup, grad_exchange=exchange)
        loss = trainer.run_batches(*batches)
        state = trainer.padded_params()
        state.update({f"{name}.{i}": x for name, pair in trainer.state["moments"].items() for i, x in enumerate(pair)})
        results[lookup, exchange] = (loss, state)
    base_loss, base = results["psum", "allgather"]
    for (lookup, exchange), (loss, state) in results.items():
        exact = exchange == "allgather" or mesh_shape[0] == 1
        assert torch.equal(loss, base_loss)
        for name, value in state.items():
            if exact:
                assert torch.equal(value, base[name]), (lookup, exchange, name)
            else:
                np.testing.assert_allclose(value.numpy(), base[name].numpy(), rtol=1e-6, atol=1e-6, err_msg=name)


def test_overflow_count_equals_jax(split):
    """Zipf-skewed, frequency-sorted item ids put most unique ids on shard 0;
    at capacity_factor 0.25 the bucketed exchange drops gradient rows, and the
    port counts the same number as the JAX package."""
    data, jax_data = _both_data(split)
    cfg, ref, params, ours = _models(data)
    rng = np.random.default_rng(0)
    n_rows = 256
    skewed = TrainArrays(users=rng.integers(0, data.n_users, n_rows).astype(np.int32),
                         items=np.minimum(rng.zipf(1.3, n_rows) - 1, data.n_items - 1).astype(np.int32),
                         ratings=np.ones(n_rows, np.float32))
    neg = jax_make_negative_sampler(jax_data)
    _, want_state, _ = _jax_epoch(ref, params, skewed, neg, (2, 2), jax.random.key(3),
                                  grad_exchange="bucketed", capacity_factor=0.25)
    trainer = _port_trainer(data, ours, cfg, (2, 2), arrays=skewed, grad_exchange="bucketed", capacity_factor=0.25)
    trainer.run_batches(*_jax_batches(jax.random.key(3), skewed, neg, BATCH))
    assert int(trainer.dropped) == int(want_state["dropped"]) > 0


def test_ring_lookup_overflow_is_counted(split):
    """A ring bucket holds batch positions: a shard that owns more than C of
    them serves the rest as zero rows (the JAX package's semantics), and
    ``lookup_overflow`` counts exactly those positions."""
    data, _ = _both_data(split)
    cfg, _, _, ours = _models(data)
    rng = np.random.default_rng(1)
    users = np.where(rng.random(BATCH) < 0.8, rng.integers(0, 15, BATCH), rng.integers(0, data.n_users, BATCH))
    items = rng.integers(0, data.n_items, (2, BATCH))
    trainer = _port_trainer(data, ours, cfg, (1, 4), lookup_strategy="ring", capacity_factor=1.0)
    trainer.run_batches(users[None], items[:1], items[1:])
    capacity = trainer._capacity_for(BATCH)  # 16 user slots a shard
    want = 0
    for ids, n_rows in ((users, data.n_users), (items.reshape(-1), data.n_items)):
        owners = np.bincount(ids // -(-n_rows // 4), minlength=4)
        want += int(np.clip(owners - trainer._capacity_for(len(ids)), 0, None).sum())
    assert capacity == 16 and int(trainer.lookup_overflow) == want > 0


# -- end to end ----------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_split():
    """The 60 x 40 structured data of tests/test_sharded_sparse.py, with a
    test copy: (port BaseData, JAX BaseData)."""
    flagged = leave_one_out(make_structured_interactions(n_users=60, n_items=40, per_user=8))
    sampler = AliasTable(flagged[DEFAULT_ITEM_COL].value_counts().to_dict())
    train = flagged[flagged[DEFAULT_FLAG_COL] == "train"].copy()
    valid = feed_neg_sample(flagged[flagged[DEFAULT_FLAG_COL] == "validate"].copy(), 20, sampler)
    test = feed_neg_sample(flagged[flagged[DEFAULT_FLAG_COL] == "test"].copy(), 20, sampler)

    def frame(df):
        return {c: df[c].to_numpy() for c in df.columns if c != DEFAULT_FLAG_COL}

    return BaseData((frame(train), [frame(valid)], [frame(test)])), JaxBaseData((train, [valid], [test]))


def _config(root, mesh, **model):
    return {
        "system": {"root_dir": str(root), "metrics": ["ndcg", "recall"], "k": [5, 10], "valid_metric": "ndcg",
                   "valid_k": 10, "seed": 11, "result_file": "mf_test.csv", "mesh": mesh},
        "dataset": {"dataset": "synthetic", "data_split": "leave_one_out"},
        "model": {"model": "MF", "loss": "bpr", "emb_dim": 16, "batch_size": 128, "optimizer": "adam", "lr": 0.05,
                  "max_epoch": 30, "max_n_update": 30, "sparse_optim": True, **model},
    }


def test_mesh_training_learns_with_the_ring(engine_split, tmp_path):
    """On a (1, 4) mesh of CPU devices the ring lookup and (at a model axis
    of 4) the bucketed exchange reach the JAX package's bar of 0.32."""
    data, _ = engine_split
    rec = MatrixFactorization(Config(_config(tmp_path, {"data": 1, "model": 4}, lookup_strategy="ring")),
                              device="cpu", mesh_devices=["cpu"] * 4)
    result = rec.train(data)
    trainer = rec.engine.epoch_fn
    assert isinstance(trainer, ShardedSparseEpochTrainer)
    assert (trainer.lookup_strategy, trainer.grad_exchange) == ("ring", "bucketed")
    assert result["valid_metric"] > 0.32, result
    assert int(trainer.dropped) == int(trainer.lookup_overflow) == 0 and rec.test()["ndcg@10"] > 0.32


def test_port_checkpoint_of_a_padded_run_loads_in_jax(engine_split, tmp_path):
    """A (1, 3) mesh pads the 40-item table to 42 rows; the JAX package's
    cold load + test() of that checkpoint gives the port's metrics."""
    data, jax_data = engine_split
    rec = MatrixFactorization(Config(_config(tmp_path / "port", {"data": 1, "model": 3}, lookup_strategy="ring",
                                             max_epoch=4)), device="cpu", mesh_devices=["cpu"] * 3)
    result = rec.train(data)
    ours = rec.test()
    raw = load_raw_checkpoint(result["model_save_dir"])
    assert raw["params"]["item_emb"].shape[0] == 42 > data.n_items
    assert raw["opt_state"]["0"]["mu"]["item_emb"].shape == raw["params"]["item_emb"].shape
    jax_cfg = JaxConfig(json.loads(json.dumps(_config(tmp_path / "jax", None))))
    want = JaxMatrixFactorization(jax_cfg).load(result["model_save_dir"], jax_data).test()
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    top = rec.recommend(users=np.arange(data.n_users), k=data.n_items, exclude_train=False)
    assert int(top[DEFAULT_ITEM_COL].max()) < data.n_items  # no pad item is ranked


def test_jax_sharded_checkpoint_serves_in_the_port(engine_split, tmp_path):
    """The JAX package's (1, 3)-mesh run writes padded tables; the port loads
    them (the pad rows cut) and gives the JAX package's test() metrics."""
    data, jax_data = engine_split
    cfg = _config(tmp_path, {"data": 1, "model": 3}, max_epoch=3)
    jax_rec = JaxMatrixFactorization(JaxConfig(json.loads(json.dumps(cfg))))
    ckpt = jax_rec.train(jax_data)["model_save_dir"]
    want = jax_rec.test()
    assert load_raw_checkpoint(ckpt)["params"]["item_emb"].shape[0] == 42
    ours = MatrixFactorization(Config(cfg), device="cpu").load(ckpt, data).test()
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)


def test_mesh_routing(engine_split, tmp_path, monkeypatch, capsys):
    """Too few devices raise; a mesh on the dense path trains through the
    dense mesh step; "auto" routes as the JAX package does; the exchange
    defaults by the model axis; the bucketed exchange warns when it drops
    rows."""
    data, _ = engine_split

    def engine(mesh, devices, **model):
        config = Config(_config(tmp_path, mesh, **model))
        model = build_model(config.model, data.n_users, data.n_items, {}, "cpu")
        return train_engine.TrainEngine(config, "cpu", devices).build(model, data)

    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        engine({"data": 1, "model": 4}, None)
    for sparse in (False, "auto"):
        dense = engine({"data": 2, "model": 1}, ["cpu"] * 2, sparse_optim=sparse)
        assert not dense.sharded and dense.epoch_fn.dp.mode == "data"
    assert not engine({"data": 1, "model": 1}, None, sparse_optim=False).sharded  # one device: the dense path
    monkeypatch.setattr(train_engine, "AUTO_SPARSE_TABLE_BYTES", 0)
    auto = engine("auto", ["cpu"] * 2, sparse_optim="auto")
    assert auto.sharded and auto.mesh.shape == {"data": 2, "model": 1} and "[auto]" in capsys.readouterr().out
    assert engine({"data": 1, "model": 2}, ["cpu"] * 2).epoch_fn.grad_exchange == "allgather"
    with pytest.raises(ValueError, match="lookup_strategy"):
        engine({"data": 1, "model": 2}, ["cpu"] * 2, lookup_strategy="alltoall")
    starved = engine({"data": 1, "model": 4}, ["cpu"] * 4, capacity_factor=0.05, lookup_strategy="ring")
    assert starved.epoch_fn.grad_exchange == "bucketed"
    starved.train(max_epoch=1, verbose=False)
    out = capsys.readouterr().out
    assert starved.dropped_grad_rows > 0 and "WARNING: sharded-sparse bucketed exchange dropped" in out
    assert starved.lookup_overflow > 0 and "WARNING: sharded-sparse ring lookup served" in out


def test_negative_sampler_defaults_to_the_gpu(engine_split, monkeypatch):
    data, _ = engine_split
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_negative_sampler(data)
