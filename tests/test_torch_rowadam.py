"""The lazy-Adam row update: the port's plain ``fused_rowadam``, its
``_segment_dedup`` and ``sparse_adam_row_update`` against the JAX package's
(the Pallas kernel in interpret mode on the CPU) and the wrapper's dispatch.
The card's tests are in ``tests/test_torch_rowadam_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beta_recsys_tpu.core.sparse_optim import _segment_dedup as jax_segment_dedup
from beta_recsys_tpu.core.sparse_optim import sparse_adam_row_update as jax_sparse_adam_row_update
from beta_recsys_tpu.ops.pallas.rowadam import fused_rowadam as jax_fused_rowadam
from beta_recsys_tpu_torch.core.sparse_optim import _segment_dedup, sparse_adam_row_update
from beta_recsys_tpu_torch.ops.kernels.rowadam import (
    bias_corrections,
    fused_rowadam,
    fused_rowadam_reference,
)

# As tests/test_rowadam_kernel.py holds the JAX kernel: float32 Adam
# arithmetic in another order of operations (multiplied bias corrections vs
# divided ones) differs by a few ulp.
RTOL, ATOL = 1e-5, 1e-6


def _case(n, b, d, seed):
    """(table, m, v, ids, rows) as numpy, with duplicate ids likely."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    m = (0.1 * rng.standard_normal((n, d))).astype(np.float32)
    v = np.abs(0.1 * rng.standard_normal((n, d))).astype(np.float32)
    ids = rng.integers(0, n, b).astype(np.int32)
    rows = rng.standard_normal((b, d)).astype(np.float32)
    return table, m, v, ids, rows


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _jax_bc(step):
    step_f = jnp.float32(step)
    return jnp.stack([1.0 / (1.0 - 0.9**step_f), 1.0 / (1.0 - 0.999**step_f)])


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("step", [1, 7, 1000])
def test_bias_corrections_match_jax_float32(step):
    np.testing.assert_array_equal(np.float32(bias_corrections(step)), np.asarray(_jax_bc(step)))


@pytest.mark.parametrize("b,d", [(32, 8), (40, 1)])
def test_segment_dedup_matches_jax(b, d):
    _, _, _, ids, rows = _case(16, b, d, seed=b)
    want_ids, want_rows = jax_segment_dedup(jnp.asarray(ids), jnp.asarray(rows))
    got_ids, got_rows = _segment_dedup(*_t(ids.astype(np.int64), rows))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(want_rows), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,b,d,step", [(64, 32, 16, 1), (128, 48, 8, 7), (40, 24, 5, 3)])
def test_plain_version_matches_pallas_kernel_and_xla_update(n, b, d, step):
    table, m, v, ids, rows = _case(n, b, d, seed=n + d)
    ids_s, rows_d = jax_segment_dedup(jnp.asarray(ids), jnp.asarray(rows))
    want_kernel = jax_fused_rowadam(
        jnp.asarray(table), jnp.asarray(m), jnp.asarray(v), ids_s, rows_d, _jax_bc(step), 0.05
    )
    want_xla = jax_sparse_adam_row_update(
        jnp.asarray(table), jnp.asarray(m), jnp.asarray(v), jnp.asarray(ids), jnp.asarray(rows), 0.05, jnp.float32(step)
    )
    got = fused_rowadam(*_t(table, m, v, np.asarray(ids_s).astype(np.int64), rows_d), bias_corrections(step), 0.05)
    _assert_close(got, want_kernel)
    _assert_close(got, want_xla)


@pytest.mark.parametrize("shape", [(48, 8), (48,)])
def test_sparse_adam_row_update_matches_jax(shape):
    n = shape[0]
    table, m, v, ids, rows = _case(n, 30, shape[1] if len(shape) == 2 else 1, seed=len(shape))
    if len(shape) == 1:  # a bias table
        table, m, v, rows = table[:, 0], m[:, 0], v[:, 0], rows[:, 0]
    want = jax_sparse_adam_row_update(
        jnp.asarray(table), jnp.asarray(m), jnp.asarray(v), jnp.asarray(ids), jnp.asarray(rows), 0.05, jnp.float32(4)
    )
    got = sparse_adam_row_update(*_t(table, m, v, ids.astype(np.int64), rows), 0.05, 4)
    _assert_close(got, want)


def test_zero_gradient_rows_leave_table_and_moments_untouched():
    """Duplicates carry zero rows, and a row whose summed gradient cancels to
    zero is untouched too: no decay, no write."""
    n, d = 32, 8
    table, m, v = np.ones((n, d), np.float32), np.full((n, d), 0.5, np.float32), np.full((n, d), 0.25, np.float32)
    ids = np.array([3, 3, 3, 7, 9, 9], np.int64)
    rows = np.zeros((6, d), np.float32)
    rows[0], rows[3], rows[4], rows[5] = 1.0, 2.0, 1.5, -1.5
    ids_s, rows_d = _segment_dedup(*_t(ids, rows))
    assert not rows_d[4:].any()  # id 9's gradients cancel
    got_t, got_m, got_v = fused_rowadam(*_t(table, m, v), ids_s, rows_d, bias_corrections(1), 0.1)
    for r in range(n):
        if r in (3, 7):
            assert not np.allclose(got_t[r].numpy(), 1.0)
        else:
            assert got_t[r].numpy().tobytes() == table[r].tobytes()
            assert got_m[r].numpy().tobytes() == m[r].tobytes()
            assert got_v[r].numpy().tobytes() == v[r].tobytes()


def test_cpu_route_is_the_plain_version_and_counts_no_launch():
    table, m, v, ids, rows = _case(20, 10, 4, seed=5)
    ids_s, rows_d = _segment_dedup(*_t(ids.astype(np.int64), rows))
    before = fused_rowadam.launches
    got = fused_rowadam(*_t(table, m, v), ids_s, rows_d, bias_corrections(2), 0.05)
    want = fused_rowadam_reference(*_t(table, m, v), ids_s, rows_d, bias_corrections(2), 0.05)
    assert fused_rowadam.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    table, m, v, ids, rows = _t(*_case(20, 10, 4, seed=6))
    ids = ids.long()
    bc = bias_corrections(1)
    with pytest.raises(TypeError, match="float32"):
        fused_rowadam(table.double(), m.double(), v.double(), ids, rows.double(), bc, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rowadam(table, m, v, ids, rows.T.contiguous().T, bc, 0.1)
    with pytest.raises(TypeError, match="int64"):
        fused_rowadam(table, m, v, ids.float(), rows, bc, 0.1)
    with pytest.raises(TypeError, match="int64"):
        fused_rowadam(table, m, v, ids.int(), rows, bc, 0.1)
    with pytest.raises(ValueError, match=r"\(L, d\)"):
        fused_rowadam(table, m, v, ids[:5], rows, bc, 0.1)

