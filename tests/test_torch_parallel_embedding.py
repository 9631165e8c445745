"""The port's mesh, collectives and sharded-table lookups against the JAX
package's: the same tables and ids (numpy, from a seed) through
``beta_recsys_tpu_torch.parallel`` on meshes of repeated CPU devices and
through ``beta_recsys_tpu.parallel`` on meshes of ``jax.devices()`` (the
Pallas ring in interpret mode). A lookup copies rows, so the two agree
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from beta_recsys_tpu.parallel import embedding as jax_embedding
from beta_recsys_tpu_torch.parallel import embedding
from beta_recsys_tpu_torch.parallel.collectives import all_gather, psum
from beta_recsys_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

N_ROWS, D = 61, 32  # 61 rows: the pad is real on every model axis tried


def _jax_mesh(n_data, n_model):
    return Mesh(np.array(jax.devices()[: n_data * n_model]).reshape(n_data, n_model), ("data", "model"))


def test_make_mesh_shapes_and_refuses_too_few_devices():
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    assert mesh.shape == {DATA_AXIS: 2, MODEL_AXIS: 2} and mesh.size == 4
    assert mesh.devices == [[torch.device("cpu")] * 2] * 2
    assert make_mesh(n_model=2, devices=["cpu"] * 6).shape == {DATA_AXIS: 3, MODEL_AXIS: 2}
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        make_mesh(1, 4, ["cpu"])
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh(2, 4, ["cpu"] * 6)


def test_default_devices_need_cuda(monkeypatch):
    """With no devices named, a mesh is built from the CUDA devices; without
    CUDA that raises, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)


def test_collectives_add_in_rank_order_and_share_a_device():
    parts = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]), torch.tensor([-1e8])]
    summed = psum(parts)
    assert [float(s) for s in summed] == [float((parts[0] + parts[1]) + parts[2])] * 3
    assert summed[0] is summed[1] is summed[2]  # one CPU device: one result
    gathered = all_gather([torch.arange(2), torch.arange(2, 5)])
    assert torch.equal(gathered[0], torch.arange(5)) and gathered[0] is gathered[1]


def test_pad_and_shard_table():
    table = torch.arange(N_ROWS * 2, dtype=torch.float32).view(N_ROWS, 2)
    np.testing.assert_array_equal(embedding.pad_table(table, 4).numpy(),
                                  np.asarray(jax_embedding.pad_table(jnp.asarray(table.numpy()), 4)))
    mesh = make_mesh(2, 4, ["cpu"] * 8)
    shards = embedding.shard_table(table, mesh)
    assert [[s.shape[0] for s in row] for row in shards] == [[16] * 4] * 2
    assert torch.equal(torch.cat(shards[1])[:N_ROWS], table)
    assert shards[0][0].data_ptr() != shards[1][0].data_ptr()  # each replica its own copy


@pytest.mark.parametrize("capacity", [3, 8, 40])
def test_bucket_positions_equal_jax(capacity):
    """The same slots, and len(ids) at empty and overflow slots."""
    rng = np.random.default_rng(capacity)
    ids = np.concatenate([rng.integers(0, 16, 20), rng.integers(0, 64, 20)])  # shard 0 overfull
    want = jax_embedding.bucket_positions(jnp.asarray(ids, jnp.int32), 4, capacity, 16)
    got = embedding.bucket_positions(torch.from_numpy(ids), 4, capacity, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("lookup", ["psum_gather", "psum_gather_sharded_batch", "bucketed_psum_gather",
                                    "rdma_bucketed_gather"])
def test_lookups_equal_jax(mesh_shape, lookup):
    n_data, n_model = mesh_shape
    rng = np.random.default_rng(7)
    table = np.random.default_rng(1).standard_normal((N_ROWS, D)).astype(np.float32)
    ids = rng.integers(0, N_ROWS, 40)
    jax_mesh = _jax_mesh(n_data, n_model)
    padded = jax.device_put(jax_embedding.pad_table(jnp.asarray(table), n_model),
                            NamedSharding(jax_mesh, P("model", None)))
    jax_lookup = jax.jit(lambda t, i: getattr(jax_embedding, lookup)(t, i, jax_mesh))  # eager shard_map is slow
    want = np.asarray(jax_lookup(padded, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_array_equal(want, table[ids])

    mesh = make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model))
    out = getattr(embedding, lookup)(embedding.shard_table(torch.from_numpy(table), mesh), torch.from_numpy(ids), mesh)
    data_sharded = lookup in ("psum_gather_sharded_batch", "bucketed_psum_gather")
    for d in range(n_data):
        for m in range(n_model):
            part = want.reshape(n_data, -1, D)[d] if data_sharded else want
            np.testing.assert_array_equal(out[d][m].numpy(), part)


@pytest.mark.parametrize("lookup", ["rdma_bucketed_gather", "bucketed_psum_gather"])
def test_skewed_ids_overflow_to_zero_rows_as_in_jax(lookup):
    """Every id on shard 0 at capacity_factor 1: the first C rows exact, the
    rest zero, in both packages."""
    table = np.random.default_rng(3).standard_normal((64, 16)).astype(np.float32)
    ids = np.zeros(32, np.int64)
    jax_mesh = _jax_mesh(1, 4)
    placed = jax.device_put(jnp.asarray(table), NamedSharding(jax_mesh, P("model", None)))
    jax_lookup = jax.jit(lambda t, i: getattr(jax_embedding, lookup)(t, i, jax_mesh, capacity_factor=1.0))
    want = np.asarray(jax_lookup(placed, jnp.asarray(ids, jnp.int32)))
    mesh = make_mesh(1, 4, ["cpu"] * 4)
    got = getattr(embedding, lookup)(embedding.shard_table(torch.from_numpy(table), mesh), torch.from_numpy(ids),
                                     mesh, capacity_factor=1.0)
    for out in got[0]:
        np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(want[:8], np.tile(table[0], (8, 1)))
    np.testing.assert_array_equal(want[8:], 0.0)


def test_local_psum_gather_takes_bias_tables():
    """1-D tables (MF's biases) look up scalars through the same psum."""
    bias = np.random.default_rng(5).standard_normal(N_ROWS).astype(np.float32)
    mesh = make_mesh(1, 4, ["cpu"] * 4)
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, N_ROWS, 30))
    out = embedding.psum_gather(embedding.shard_table(torch.from_numpy(bias), mesh), ids, mesh)
    for part in out[0]:
        np.testing.assert_array_equal(part.numpy(), bias[ids.numpy()])
