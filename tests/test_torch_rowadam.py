"""The lazy-Adam row update: the port's plain ``fused_rowadam`` (one table
and grouped), its ``_segment_dedup`` and ``sparse_adam_row_update`` against
the JAX package's (the Pallas kernel in interpret mode on the CPU), the
wrapper's dispatch and checks, and the trainer's one grouped call a step.
The card's tests are in ``tests/test_torch_rowadam_cuda.py``."""

import ctypes
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beta_recsys_tpu.core.sparse_optim import _segment_dedup as jax_segment_dedup
from beta_recsys_tpu.core.sparse_optim import sparse_adam_row_update as jax_sparse_adam_row_update
from beta_recsys_tpu.ops.pallas.rowadam import fused_rowadam as jax_fused_rowadam
from beta_recsys_tpu_torch.core.sparse_optim import SparseEpochTrainer, _segment_dedup, sparse_adam_row_update
from beta_recsys_tpu_torch.models.mf import MF
from beta_recsys_tpu_torch.ops.kernels import rowadam
from beta_recsys_tpu_torch.ops.kernels.rowadam import (
    RowAdamTables,
    bias_corrections,
    fused_rowadam,
    fused_rowadam_reference,
    fused_rowadam_tables,
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



@pytest.mark.parametrize("step", [1, 9])
def test_grouped_plain_version_matches_pallas_kernel_and_xla_update_per_table(step):
    """One grouped call over three tables of other shapes is the JAX kernel
    (and the JAX XLA update) of each table on its own."""
    cases = [_case(64, 32, 16, seed=11), _case(90, 40, 8, seed=12), _case(40, 24, 5, seed=13)]
    want_kernel, want_xla, tables, ids, grads = [], [], [], [], []
    for table, m, v, i, rows in cases:
        ids_s, rows_d = jax_segment_dedup(jnp.asarray(i), jnp.asarray(rows))
        want_kernel.append(jax_fused_rowadam(
            jnp.asarray(table), jnp.asarray(m), jnp.asarray(v), ids_s, rows_d, _jax_bc(step), 0.05))
        want_xla.append(jax_sparse_adam_row_update(
            jnp.asarray(table), jnp.asarray(m), jnp.asarray(v), jnp.asarray(i), jnp.asarray(rows), 0.05,
            jnp.float32(step)))
        tables.append(_t(table, m, v))
        got_ids, got_rows = _t(np.asarray(ids_s).astype(np.int64), rows_d)
        ids.append(got_ids)
        grads.append(got_rows)
    got = fused_rowadam_tables(tables, ids, grads, bias_corrections(step), 0.05)
    assert got == tables  # updated in place
    for triple, wk, wx in zip(got, want_kernel, want_xla):
        _assert_close(triple, wk)
        _assert_close(triple, wx)


def test_group_rejects_tables_that_share_memory():
    """The kernel updates every table of a group at once, so no two of the
    group's tables and moments may overlap."""
    table, m, v, _, _ = _t(*_case(20, 10, 4, seed=7))
    other = [x.clone() for x in (table, m, v)]
    for group in ([(table, m, v), (table, *other[1:])],       # one table twice
                  [(table, m, m)],                           # m is v
                  [(table[:12], m[:12], v[:12]), (table[8:], *[x[8:] for x in other[1:]])]):  # overlapping views
        with pytest.raises(ValueError, match="share memory"):
            RowAdamTables(group)
    RowAdamTables([(table[:8], m[:8], v[:8]), (table[8:], m[8:], v[8:])])  # adjacent views are fine


def test_group_checks_its_calls():
    (table, m, v, ids, rows), (t2, m2, v2, _, _) = _t(*_case(20, 10, 4, seed=8)), _t(*_case(30, 6, 4, seed=9))
    group = RowAdamTables([(table, m, v), (t2, m2, v2)])
    ids = ids.long()
    with pytest.raises(ValueError, match="one ids and one grads a table"):
        group([ids], [rows], bias_corrections(1), 0.1)
    with pytest.raises(TypeError, match="int64"):
        group([ids, ids.int()], [rows, rows], bias_corrections(1), 0.1)
    with pytest.raises(ValueError, match="tables, not 9"):
        RowAdamTables([tuple(x.clone() for x in (table, m, v)) for _ in range(9)])
    with pytest.raises(ValueError, match="one"):
        RowAdamTables([(table, m, v[:5])])


def test_call_struct_has_the_c_layout():
    """``_RowAdamCall`` mirrors ``RowAdamCall`` of csrc/rowadam.cu field for
    field (and ``_RowAdamTable`` its ``RowAdamTable``): the same names in the
    same order, at the C layout's offsets on a 64-bit host, so the C call
    reads what the wrapper wrote."""
    source = (Path(rowadam.__file__).parents[2] / "csrc" / "rowadam.cu").read_text()
    for struct, ours in (("RowAdamTable", rowadam._RowAdamTable), ("RowAdamCall", rowadam._RowAdamCall)):
        body = re.search(rf"struct {struct} \{{(.*?)\}};", source, re.S).group(1)
        assert re.findall(r"(\w+)(?:\[kMaxTables\])?;", body) == [name for name, _ in ours._fields_]
    assert re.search(r"constexpr int kMaxTables = (\d+);", source).group(1) == str(rowadam.MAX_TABLES)
    table = rowadam._RowAdamTable
    assert (table.ids.offset, table.n_rows.offset, table.n_ids.offset, table.d.offset) == (24, 40, 48, 52)
    assert ctypes.sizeof(table) == 56
    call = rowadam._RowAdamCall
    assert (call.count.offset, call.lr.offset, call.bc2.offset, ctypes.sizeof(call)) == (448, 452, 480, 488)


def test_trainer_fused_route_makes_one_grouped_call_a_step():
    """MF's two 2-D tables (user_emb, item_emb) update in one grouped call a
    step, checked once when the trainer is built; the 1-D bias tables take
    ``sparse_adam_row_update``. On the CPU the call takes the plain version
    and launches nothing."""
    model = MF({"emb_dim": 8, "loss": "bpr"}, 10, 12, device="cpu").init_weights(torch.Generator().manual_seed(0))
    arrays = types.SimpleNamespace(users=np.arange(10), items=np.arange(10))
    trainer = SparseEpochTrainer(model, arrays, 4, None, 0.05, None, row_update="fused")
    trainer.dense_optimizer = torch.optim.Adam(list(trainer.dense.values()), lr=0.05)
    assert trainer.fused == ["user_emb", "item_emb"]
    assert [t[0].data_ptr() for t in trainer.row_adam.tables] == [
        model.user_emb.data_ptr(), model.item_emb.data_ptr()]
    gen = torch.Generator().manual_seed(0)
    calls, launches = fused_rowadam_tables.calls, fused_rowadam.launches
    before = model.item_emb.detach().clone()
    for _ in range(3):
        users, pos, neg = (torch.randint(0, n, (4,), generator=gen) for n in (10, 12, 12))
        assert torch.isfinite(trainer.step(users, pos, neg))
    assert fused_rowadam_tables.calls == calls + 3 and fused_rowadam.launches == launches
    assert not torch.equal(model.item_emb.detach(), before)
