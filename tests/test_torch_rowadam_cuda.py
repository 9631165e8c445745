"""On a card: the ``fused_rowadam`` CUDA kernel against its plain version,
for one table and for a group of tables in one launch, ids outside the
table left unwritten, and the segment dedup repeating bit for bit; the
packed entry points (``fused_rowadam_packed``, ``fused_rowadam_packed_bf16``)
against their plain versions bit for bit, and each packed layout's trainer
launching one kernel a step. Imports nothing of JAX, so it runs on the
card's machine:

    python3 -m pytest --noconftest tests/test_torch_rowadam_cuda.py -q

(``tests/conftest.py`` configures JAX, which that machine does not have).
Every test skips without a CUDA device.
"""

import types

import numpy as np
import pytest
import torch

from beta_recsys_tpu_torch.core.sparse_optim import SparseEpochTrainer, _segment_dedup
from beta_recsys_tpu_torch.models.mf import MF
from beta_recsys_tpu_torch.ops.kernels.rowadam import (
    bias_corrections,
    bias_denominators,
    fused_rowadam,
    fused_rowadam_packed,
    fused_rowadam_packed_bf16,
    fused_rowadam_packed_bf16_reference,
    fused_rowadam_packed_reference,
    fused_rowadam_reference,
    fused_rowadam_tables,
    fused_rowadam_tables_reference,
    repack16,
)

# As tests/test_rowadam_kernel.py holds the JAX kernel; the card's kernel
# rounds the same float32 operations on their own, as the plain version does.
RTOL, ATOL = 1e-5, 1e-6


def _case(n, b, d, seed):
    """(table, m, v, ids, rows) on the card, with duplicate ids likely."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    m = (0.1 * rng.standard_normal((n, d))).astype(np.float32)
    v = np.abs(0.1 * rng.standard_normal((n, d))).astype(np.float32)
    ids = rng.integers(0, n, b)
    rows = rng.standard_normal((b, d)).astype(np.float32)
    return tuple(torch.from_numpy(x).cuda() for x in (table, m, v, ids, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,d", [(943, 400, 64), (1682, 800, 64), (300, 64, 1), (300, 64, 65), (300, 64, 128)])
def test_cuda_kernel_matches_plain_version(n, b, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    table, m, v, ids, rows = _case(n, b, d, seed=d)
    rows[::7] = 0.0  # all-zero gradient rows besides the duplicates
    ids_s, rows_d = _segment_dedup(ids, rows)
    want = fused_rowadam_reference(table.clone(), m.clone(), v.clone(), ids_s, rows_d, bias_corrections(3), 0.05)
    before = fused_rowadam.launches
    got = fused_rowadam(table.clone(), m.clone(), v.clone(), ids_s, rows_d, bias_corrections(3), 0.05)
    torch.cuda.synchronize()
    assert fused_rowadam.launches == before + 1
    untouched = torch.ones(n, dtype=torch.bool, device="cuda")
    untouched[ids_s[(rows_d != 0).any(dim=1)]] = False
    for g, w, orig in zip(got, want, (table, m, v)):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
        assert torch.equal(g[untouched], orig[untouched])


@pytest.mark.cuda
def test_cuda_grouped_kernel_matches_per_table_plain_versions():
    """One launch over MF's step (943 x 64 with L 400, 1682 x 64 with L 800)
    and tables of other widths (d 65 and d 1 take one float a lane, d 8 two
    float4 lanes a row): each table as its own plain version leaves it, and
    every untouched row bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    shapes = [(943, 400, 64), (1682, 800, 64), (300, 64, 65), (50, 40, 1), (120, 90, 8)]
    tables, ids, grads = [], [], []
    for i, (n, b, d) in enumerate(shapes):
        table, m, v, idx, rows = _case(n, b, d, seed=10 + i)
        rows[::7] = 0.0
        ids_s, rows_d = _segment_dedup(idx, rows)
        tables.append((table, m, v))
        ids.append(ids_s)
        grads.append(rows_d)
    bc = bias_corrections(5)
    want = fused_rowadam_tables_reference([tuple(x.clone() for x in t) for t in tables], ids, grads, bc, 0.05)
    got = [tuple(x.clone() for x in t) for t in tables]
    before = fused_rowadam.launches
    fused_rowadam_tables(got, ids, grads, bc, 0.05)
    torch.cuda.synchronize()
    assert fused_rowadam.launches == before + 1
    for (n, _, _), g_t, w_t, orig, i, g in zip(shapes, got, want, tables, ids, grads):
        untouched = torch.ones(n, dtype=torch.bool, device="cuda")
        untouched[i[(g != 0).any(dim=1)]] = False
        for x, w, o in zip(g_t, w_t, orig):
            torch.testing.assert_close(x, w, rtol=RTOL, atol=ATOL)
            assert torch.equal(x[untouched], o[untouched])


@pytest.mark.cuda
def test_cuda_ids_outside_the_table_are_not_written():
    """A row with a gradient and an id outside [0, n_rows) writes nothing;
    the other rows update as the plain version updates them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    table, m, v, _, rows = _case(100, 6, 64, seed=3)
    ids = torch.tensor([-1, 4, 9, 100, 57, 1 << 40], device="cuda")
    valid = (ids >= 0) & (ids < 100)
    want = fused_rowadam_reference(table.clone(), m.clone(), v.clone(), ids.clamp(0, 99),
                                   torch.where(valid[:, None], rows, 0.0), bias_corrections(2), 0.05)
    got = fused_rowadam(table.clone(), m.clone(), v.clone(), ids, rows, bias_corrections(2), 0.05)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_segment_dedup_repeats_bit_for_bit():
    """The segment sums add in a fixed order on the card, so a training run
    repeats exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, 50, (4096,), generator=gen, device="cuda")  # many duplicates
    rows = torch.randn(4096, 64, generator=gen, device="cuda")
    first = _segment_dedup(ids, rows)
    for _ in range(3):
        again = _segment_dedup(ids, rows)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


@pytest.mark.cuda
def test_cuda_auto_row_update_takes_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = MF({"emb_dim": 8, "loss": "bpr"}, 10, 12, device="cuda").init_weights(torch.Generator().manual_seed(0))
    arrays = types.SimpleNamespace(users=np.arange(10), items=np.arange(10))
    trainer = SparseEpochTrainer(model, arrays, 4, None, 0.05, None, row_update="auto")
    assert trainer.row_update == "fused"


# MF's packed layout at configs/mf_default.json (emb 64 + a bias column): the
# user role's rows 0-942, the items' 943-2624; the bf16 form holds the two
# embeddings alone. And a layout whose roles differ in their columns.
MF_RECTS = [(0, 943, 0, 64), (0, 943, 64, 1), (943, 1682, 0, 64), (943, 1682, 64, 1)]
MF_RECTS16 = [(0, 943, 0, 64), (943, 1682, 0, 64)]
ROLE_RECTS = [(0, 100, 0, 8), (0, 100, 8, 3), (100, 50, 0, 1), (100, 50, 1, 10)]


def _packed_case(total_rows, w, n_ids, seed, bf16=False):
    """(packed, sorted ids with duplicates and one id past the table, their
    deduplicated gradients) on the card; every 7th gradient row zero."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(total_rows, w, generator=gen, device="cuda")
    m = 0.1 * torch.randn(total_rows, w, generator=gen, device="cuda")
    v = (0.1 * torch.randn(total_rows, w, generator=gen, device="cuda")).abs()
    packed = repack16(p, m, v) if bf16 else torch.cat([p, m, v], dim=1)
    ids = torch.randint(0, total_rows, (n_ids,), generator=gen, device="cuda")
    ids[-1] = total_rows + 5
    grads = torch.randn(n_ids, w, generator=gen, device="cuda")
    grads[::7] = 0.0
    ids_s, g_d = _segment_dedup(ids, grads)
    return packed.contiguous(), ids_s, g_d


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rects,total_rows,w,n_ids", [
    (MF_RECTS, 2625, 65, 1200), (ROLE_RECTS, 150, 11, 300),
], ids=["mf-step", "role-indicator"])
def test_cuda_packed_kernels_match_plain_versions_bit_for_bit(bf16, rects, total_rows, w, n_ids):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if bf16:
        rects = [r for r in rects if r[3] > 1]
    packed, ids, grads = _packed_case(total_rows, w, n_ids, seed=w, bf16=bf16)
    denoms = bias_denominators(3)
    plain = fused_rowadam_packed_bf16_reference if bf16 else fused_rowadam_packed_reference
    kernel = fused_rowadam_packed_bf16 if bf16 else fused_rowadam_packed
    want = plain(packed.clone(), rects, ids, grads, denoms, 0.05)
    before = kernel.launches
    got = kernel(packed.clone(), rects, ids, grads, denoms, 0.05)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, want)
    assert not torch.equal(got, packed)


@pytest.mark.cuda
@pytest.mark.parametrize("row_update", ["unified", "compact", "unified_bf16"])
def test_cuda_packed_layouts_launch_once_a_step(row_update):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = MF({"emb_dim": 8, "loss": "bpr"}, 10, 12, device="cuda").init_weights(torch.Generator().manual_seed(0))
    arrays = types.SimpleNamespace(users=np.arange(10), items=np.arange(10))
    trainer = SparseEpochTrainer(model, arrays, 4, None, 0.05, None, row_update=row_update)
    trainer.dense_optimizer = torch.optim.Adam(list(trainer.dense.values()), lr=0.05)
    kernel = fused_rowadam_packed_bf16 if row_update == "unified_bf16" else fused_rowadam_packed
    before, item_emb = kernel.launches, model.item_emb.detach().clone()
    gen = torch.Generator(device="cuda").manual_seed(0)
    users, pos, neg = (torch.randint(0, n, (3, 4), generator=gen, device="cuda") for n in (10, 12, 12))
    assert torch.isfinite(trainer.run_batches(users, pos, neg))
    torch.cuda.synchronize()
    assert kernel.launches == before + 3
    assert not torch.equal(model.item_emb.detach(), item_emb)
