"""The ring all-gather in the port against the JAX package: its plain version
against the Pallas kernel (interpret mode on the CPU devices) block for
block, its autograd backward (the reduce-scatter) against ``jax.grad``
through ``rdma_bucketed_gather``, and the checks its CUDA wrapper makes
before a launch. The kernel itself runs only on a card
(``tests/test_torch_ring_exchange_cuda.py``)."""

import ctypes
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from beta_recsys_tpu.ops.pallas.ring_exchange import ring_allgather as jax_ring_allgather
from beta_recsys_tpu.parallel.embedding import pad_table as jax_pad_table
from beta_recsys_tpu.parallel.embedding import rdma_bucketed_gather as jax_rdma_bucketed_gather
from beta_recsys_tpu_torch.ops.kernels import ring_exchange
from beta_recsys_tpu_torch.ops.kernels.ring_exchange import ring_allgather, ring_allgather_reference
from beta_recsys_tpu_torch.parallel.embedding import rdma_bucketed_gather, shard_table
from beta_recsys_tpu_torch.parallel.mesh import make_mesh


def _jax_ring_outputs(blocks):
    """Every shard's (n, C, d) output of the Pallas ring over n CPU devices."""
    n = len(blocks)
    mesh = Mesh(np.array(jax.devices()[:n]), ("model",))

    @functools.partial(shard_map, mesh=mesh, in_specs=P("model"), out_specs=P("model"), check_vma=False)
    def gathered(block):
        return jax_ring_allgather(block, "model")

    out = np.asarray(gathered(jnp.asarray(np.concatenate(blocks))))
    return out.reshape(n, n, *blocks[0].shape)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", [(8, 16), (16, 128)])
def test_plain_ring_equals_the_pallas_kernel(n, shape):
    rng = np.random.default_rng(n)
    blocks = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    want = _jax_ring_outputs(blocks)
    got = ring_allgather([torch.from_numpy(b) for b in blocks])
    assert len(got) == n
    for r in range(n):
        np.testing.assert_array_equal(got[r].numpy(), want[r])
        np.testing.assert_array_equal(got[r].numpy(), np.stack(blocks))


def test_one_rank_is_the_block_itself():
    x = torch.randn(8, 16)
    (out,) = ring_allgather([x])
    assert out.shape == (1, 8, 16) and torch.equal(out[0], x)


def test_backward_matches_jax_grad_through_rdma_bucketed_gather():
    """The gradient of sum(lookup * w) with respect to the row-sharded table:
    the ring's reduce-scatter, then each shard's scatter-add (1e-6: sums of
    the same float32 rows in other orders)."""
    n_rows, d, b = 48, 32, 24
    rng = np.random.default_rng(4)
    table = rng.standard_normal((n_rows, d)).astype(np.float32)
    ids = rng.integers(0, n_rows, b)
    w = rng.standard_normal((b, d)).astype(np.float32)

    jax_mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    padded = jax.device_put(jax_pad_table(jnp.asarray(table), 4), NamedSharding(jax_mesh, P("model", None)))
    want = jax.jit(jax.grad(lambda t: jnp.sum(jax_rdma_bucketed_gather(t, jnp.asarray(ids, jnp.int32), jax_mesh)
                                              * jnp.asarray(w))))(padded)

    mesh = make_mesh(1, 4, ["cpu"] * 4)
    shards = [[s.requires_grad_() for s in row] for row in shard_table(torch.from_numpy(table), mesh)]
    out = rdma_bucketed_gather(shards, torch.from_numpy(ids), mesh)
    (out[0][0] * torch.from_numpy(w)).sum().backward()
    got = torch.cat([s.grad for s in shards[0]])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_backward_sums_every_ranks_cotangent_in_rank_order():
    blocks = [torch.randn(8, 4, dtype=torch.float64, requires_grad=True) for _ in range(3)]
    weights = [torch.randn(3, 8, 4, dtype=torch.float64) for _ in range(3)]
    sum((o * w).sum() for o, w in zip(ring_allgather(blocks), weights)).backward()
    for r, b in enumerate(blocks):
        assert torch.equal(b.grad, weights[0][r] + weights[1][r] + weights[2][r])


def test_plain_version_follows_the_ring():
    blocks = [torch.full((8, 4), float(r)) for r in range(5)]
    for out in ring_allgather_reference(blocks):
        assert torch.equal(out, torch.stack(blocks))


@pytest.mark.parametrize("case", ["row_width", "dtype", "shape", "stride", "rank_count", "not_2d"])
def test_wrapper_checks_what_the_kernel_takes(case):
    """What ``_check`` refuses before any launch (it runs on CUDA blocks; the
    check itself reads only shapes, types and strides)."""
    blocks = [torch.zeros(8, 16) for _ in range(4)]
    if case == "row_width":
        blocks = [torch.zeros(8, 3) for _ in range(4)]  # 12-byte rows
    elif case == "dtype":
        blocks[2] = blocks[2].double()
    elif case == "shape":
        blocks[1] = torch.zeros(16, 16)
    elif case == "stride":
        blocks[3] = torch.zeros(16, 8).t()
    elif case == "rank_count":
        blocks = [torch.zeros(8, 16) for _ in range(ring_exchange.MAX_RANKS + 1)]
    else:
        blocks = [torch.zeros(8, 4, 4) for _ in range(4)]
    with pytest.raises(ValueError):
        ring_exchange._check(blocks)
    ring_exchange._check([torch.zeros(8, 16, dtype=torch.bfloat16) for _ in range(2)])  # 32-byte rows pass


def test_call_struct_has_the_c_layout():
    """``_RingCall`` mirrors ``RingCall`` of csrc/ring_allgather.cu field for
    field: the same names in the same order, four arrays of 16 pointers,
    four of 16 ints, four ints, a long long and an unsigned (the C layout on
    a 64-bit host), so the C call reads what the wrapper wrote."""
    source = (Path(ring_exchange.__file__).parents[2] / "csrc" / "ring_allgather.cu").read_text()
    body = re.search(r"struct RingCall \{(.*?)\};", source, re.S).group(1)
    c_fields = re.findall(r"(\w+)(?:\[kMaxRanks\])?;", body)
    call = ring_exchange._RingCall
    assert c_fields == [name for name, _ in call._fields_]
    assert (call.x.offset, call.streams.offset, call.devs.offset, call.group.offset) == (0, 384, 512, 704)
    assert (call.n.offset, call.flag_stride.offset, call.block_vecs.offset, call.epoch.offset) == (768, 780, 784, 792)
    assert ctypes.sizeof(call) == 800
