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

from beta_recsys_tpu_torch.core.sparse_optim import SparseEpochTrainer, _segment_dedup, compact_rows
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
    packed_touched,
    repack16,
)
from beta_recsys_tpu_torch.ops.kernels.rowadam import _packed_delta

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


# -- every path of the packed write -------------------------------------------------
# The packed kernel runs one grid of G warps, 32 an SM and no more than the
# ids (G = 4,224 on a 132-SM H100); lane l of warp g reads the id at
# g + l * G, so a warp holds one id below G ids and ~L / G above. It skips
# an id equal to its predecessor, stages its candidates (first occurrences
# inside a table) with 16-, 4- or 2-byte copies by their alignment, up to 8
# rows a round (fewer for wide rows) and more rounds when it has more, and
# votes each table of a first occurrence. A two-role layout of ``w``
# columns: the users' rows 0-299 hold an embedding of w - 1 columns and a
# bias, the items' rows 300-499 one table of all w columns; rows 500-519
# belong to no table.


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _two_roles(w):
    users = [(0, 300, 0, w - 1), (0, 300, w - 1, 1)] if w > 1 else [(0, 300, 0, 1)]
    return users + [(300, 200, 0, w)]


def _packed_arrays(total_rows, w, seed, bf16):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(total_rows, w, generator=gen, device="cuda")
    m = 0.1 * torch.randn(total_rows, w, generator=gen, device="cuda")
    v = (0.1 * torch.randn(total_rows, w, generator=gen, device="cuda")).abs()
    return (repack16(p, m, v) if bf16 else torch.cat([p, m, v], dim=1)).contiguous()


def _dedup(raw_ids, w, seed, zero_every=7):
    """Sorted ids and their deduplicated gradients (every ``zero_every``-th
    raw gradient row zero) on the card, as the trainer makes them."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    ids = torch.as_tensor(raw_ids, dtype=torch.int64, device="cuda")
    grads = torch.randn(ids.shape[0], w, generator=gen, device="cuda")
    if zero_every:
        grads[::zero_every] = 0.0
    return _segment_dedup(ids, grads)


def _check_packed(bf16, rects, packed, ids, grads, wrote=True):
    """One kernel call against the plain version, bit for bit, one launch."""
    denoms = bias_denominators(4)
    plain = fused_rowadam_packed_bf16_reference if bf16 else fused_rowadam_packed_reference
    kernel = fused_rowadam_packed_bf16 if bf16 else fused_rowadam_packed
    want = plain(packed.clone(), rects, ids, grads, denoms, 0.05)
    before = kernel.launches
    got = kernel(packed.clone(), rects, ids, grads, denoms, 0.05)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, packed) != wrote
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("w", [1, 11, 33, 64, 65, 130])
@pytest.mark.parametrize("n_ids", [1237, 20_003, 40_001], ids=["1-id-a-warp", "5-ids-a-warp", "10-ids-a-warp"])
def test_cuda_packed_widths_and_ids_a_warp_bit_for_bit(card, bf16, w, n_ids):
    """Every width's copy units (bf16 at w 64 in 16-byte units, at 11 and 33
    in 4-byte ones; fp32 in 16-byte units at w 64, 4-byte ones elsewhere) at
    one id a warp (fewer ids than G) and at ~5 and ~10 (lanes of a warp
    idle at the end of the array), no count a multiple of 32 or of G; ids
    drawn over every row, those of rows 500-519 and past the array in no
    table."""
    rng = np.random.default_rng(w)
    raw = rng.integers(0, 530, n_ids)
    raw[:5] = [-3, 519, 530, 10**12, 505]
    packed = _packed_arrays(520, w, seed=w, bf16=bf16)
    ids, grads = _dedup(raw, w, seed=w)
    got = _check_packed(bf16, _two_roles(w), packed, ids, grads)
    assert torch.equal(got[500:], packed[500:])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n_ids", [0, 1])
def test_cuda_packed_no_id_and_one_id(card, bf16, n_ids):
    packed = _packed_arrays(520, 33, seed=1, bf16=bf16)
    ids, grads = _dedup(np.full(n_ids, 301), 33, seed=1, zero_every=0)
    _check_packed(bf16, _two_roles(33), packed, ids, grads, wrote=n_ids > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n_ids", [5, 9000, 40_001])
def test_cuda_packed_every_id_one_id(card, bf16, n_ids):
    """One id, n_ids times: one first occurrence carries the summed gradient,
    every other row is a duplicate that the write never reads."""
    packed = _packed_arrays(520, 65, seed=2, bf16=bf16)
    ids, grads = _dedup(np.full(n_ids, 42), 65, seed=2)
    got = _check_packed(bf16, _two_roles(65), packed, ids, grads)
    changed = (got != packed).any(dim=1)
    assert changed.sum() == 1 and changed[42]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_cuda_packed_first_ids_duplicated(card, bf16):
    """Runs of duplicates at the start of the array and across the ids of a
    warp, then distinct ids."""
    raw = np.concatenate([np.zeros(50, np.int64), np.full(17, 3), np.full(9, 299), np.full(33, 300),
                          np.arange(301, 500)])
    packed = _packed_arrays(520, 65, seed=3, bf16=bf16)
    ids, grads = _dedup(raw, 65, seed=3, zero_every=0)
    _check_packed(bf16, _two_roles(65), packed, ids, grads)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_cuda_packed_ids_outside_every_table(card, bf16):
    """Ids of rows in no table, past the array and negative: nothing written."""
    packed = _packed_arrays(520, 65, seed=4, bf16=bf16)
    ids, grads = _dedup([-7, -1, 500, 505, 519, 520, 10**9], 65, seed=4, zero_every=0)
    _check_packed(bf16, _two_roles(65), packed, ids, grads, wrote=False)


@pytest.mark.cuda
def test_cuda_packed_first_occurrence_zero_in_one_table(card):
    """A user row whose embedding gradient is zero and bias gradient is not,
    and one the other way round: only the nonzero table's columns update."""
    packed = _packed_arrays(520, 65, seed=5, bf16=False)
    ids, grads = _dedup([7, 7, 8, 9, 9, 9, 310], 65, seed=5, zero_every=0)
    grads[0, :64] = 0.0  # id 7: bias only
    grads[2, 64] = 0.0  # id 8: embedding only
    got = _check_packed(False, _two_roles(65), packed, ids, grads)
    for row, cols in ((7, slice(0, 64)), (8, slice(64, 65))):
        for part in range(3):
            span = slice(part * 65 + cols.start, part * 65 + cols.stop)
            assert torch.equal(got[row, span], packed[row, span])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n_ids", [1237, 40_001])
def test_cuda_packed_compact_cut_at_capacity_16(card, bf16, n_ids):
    """After compact's cut all but the first 16 distinct ids carry zero rows:
    first occurrences whose whole gradient is zero write nothing."""
    rng = np.random.default_rng(6)
    packed = _packed_arrays(520, 65, seed=6, bf16=bf16)
    ids, grads = _dedup(rng.integers(0, 500, n_ids), 65, seed=6)
    grads, dropped = compact_rows(ids, grads, 16)
    assert int(dropped) > 0
    got = _check_packed(bf16, _two_roles(65), packed, ids, grads)
    assert int((got != packed).any(dim=1).sum()) <= 16


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n_ids", [300, 40_001])
def test_cuda_packed_role_indicator_rects(card, bf16, n_ids):
    """ROLE_RECTS, whose roles split their 11 columns differently (8 + 3
    against 1 + 10), at one id a warp and at ~10."""
    rects = [r for r in ROLE_RECTS if r[3] > 1] if bf16 else ROLE_RECTS
    rng = np.random.default_rng(7)
    packed = _packed_arrays(150, 11, seed=7, bf16=bf16)
    ids, grads = _dedup(rng.integers(0, 155, n_ids), 11, seed=7)
    _check_packed(bf16, rects, packed, ids, grads)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("w", [11, 64, 65, 130])
def test_cuda_packed_many_rounds_a_warp_bit_for_bit(card, bf16, w):
    """~47,000 distinct ids of 50,000 over 60,000 rows (59,000-59,999 in no
    table), as a uniform step at table scale draws them: nine warps in ten
    hold more first occurrences (7-12, ~11 on an H100) than the 8 rows a
    warp stages at most at once, so they stage and update them in two
    rounds or more, reusing their shared memory after each."""
    total = 60_000
    rects = [(0, 40_000, 0, w - 1), (0, 40_000, w - 1, 1), (40_000, 19_000, 0, w)]
    rng = np.random.default_rng(10)
    raw = np.concatenate([rng.permutation(total)[:46_000], rng.integers(0, total, 4_000)])
    packed = _packed_arrays(total, w, seed=10, bf16=bf16)
    ids, grads = _dedup(raw, w, seed=10)
    n_warps = min(ids.shape[0], 32 * torch.cuda.get_device_properties(0).multi_processor_count)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    candidate = first & (ids >= 0) & (ids < 59_000)
    rows = torch.arange(ids.shape[0], device="cuda")
    per_warp = torch.bincount(rows[candidate] % n_warps, minlength=n_warps)
    assert float((per_warp > 8).float().mean()) > 0.9
    _check_packed(bf16, rects, packed, ids, grads)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("offset", ["packed", "grads"])
def test_cuda_packed_unaligned_bases(card, bf16, offset):
    """A packed array or gradient array that starts one element past a
    16-byte boundary (a contiguous view): the bf16 rows then copy in 2-byte
    units, the fp32 ones and the gradients in 4-byte units."""
    w, n_ids = 64, 40_001
    packed = _packed_arrays(520, w, seed=8, bf16=bf16)
    ids, grads = _dedup(np.random.default_rng(8).integers(0, 520, n_ids), w, seed=8)
    if offset == "packed":
        flat = torch.empty(packed.numel() + 1, dtype=packed.dtype, device="cuda")
        shifted = flat[1:].view(packed.shape)
        shifted.copy_(packed)
        packed = shifted
    else:
        flat = torch.empty(grads.numel() + 1, dtype=grads.dtype, device="cuda")
        shifted = flat[1:].view(grads.shape)
        shifted.copy_(grads)
        grads = shifted
    assert shifted.data_ptr() % 16 != 0
    denoms = bias_denominators(4)
    plain = fused_rowadam_packed_bf16_reference if bf16 else fused_rowadam_packed_reference
    kernel = fused_rowadam_packed_bf16 if bf16 else fused_rowadam_packed
    want = plain(packed.clone(), _two_roles(w), ids, grads, denoms, 0.05)
    got = kernel(packed, _two_roles(w), ids, grads, denoms, 0.05)  # in place in the unaligned view
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _indexed_fp32_reference(packed, rects, ids, grads, denoms, lr, b1=0.9, b2=0.999, eps=1e-8):
    """fused_rowadam_packed_reference's arithmetic, written back by indexing
    at the first occurrences: its index_add_ adds through the card's float
    atomics, which flush subnormal operands and sums to zero."""
    w = packed.shape[1] // 3
    mask = packed_touched(rects, ids, grads) > 0
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    write = first & mask.any(dim=1)
    rows = packed[ids[write]]
    g, mask = grads[write], mask[write]
    p, m, v = rows[:, :w], rows[:, w:2 * w], rows[:, 2 * w:]
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * (g * g)
    delta = _packed_delta(m_new, v_new, denoms, lr, eps)
    new = torch.cat([p + delta, m + (m_new - m), v + (v_new - v)], dim=1)
    packed[ids[write]] = torch.where(mask.repeat(1, 3), new, rows)
    return packed


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("spread", ["moderate", "extreme"])
def test_cuda_packed_arithmetic_across_magnitudes(card, bf16, spread):
    """The kernel's IEEE divisions and square root over a wide range of
    operands: gradients and moments drawn log-uniformly over 2^-60 to 2^60
    ("moderate") or with zeros, subnormals and magnitudes to 1e30
    ("extreme"), bit for bit at several steps' bias denominators. The float32 form is held against the
    plain arithmetic written back by indexing (``_indexed_fp32_reference``),
    and against the plain version itself where no value is subnormal."""
    rng = np.random.default_rng(9)
    w, total_rows, n_ids = 64, 4096, 40_001
    shape = (total_rows, w)
    if spread == "moderate":
        def draw(size):
            return np.exp2(rng.uniform(-60, 60, size)) * rng.choice([-1.0, 1.0], size)
    else:
        pool = np.array([0.0, 1e-45, 1e-40, 1e-38, 1e-30, 1e-20, 1e-12, 1e-6, 1e-3, 0.5, 1.0, 3.0, 1e3, 1e6,
                         1e12, 1e20, 1e30])

        def draw(size):
            return rng.choice(pool, size) * rng.choice([-1.0, 1.0], size) * rng.uniform(0.5, 2.0, size)
    p, m = (torch.as_tensor(draw(shape), dtype=torch.float32, device="cuda") for _ in range(2))
    v = torch.as_tensor(np.abs(draw(shape)), dtype=torch.float32, device="cuda")
    packed = (repack16(p, m, v) if bf16 else torch.cat([p, m, v], dim=1)).contiguous()
    ids, grads = _dedup(rng.integers(0, total_rows, n_ids), w, seed=9, zero_every=0)
    grads = torch.where(grads != 0, torch.as_tensor(draw(grads.shape), dtype=torch.float32, device="cuda"), 0.0)
    rects = [(0, total_rows, 0, w)]
    kernel = fused_rowadam_packed_bf16 if bf16 else fused_rowadam_packed
    plains = [fused_rowadam_packed_bf16_reference] if bf16 else [_indexed_fp32_reference]
    if not bf16 and spread == "moderate":
        plains.append(fused_rowadam_packed_reference)
    bits = torch.int16 if bf16 else torch.int32
    for step in (1, 2, 10, 1000):
        denoms = bias_denominators(step)
        got = kernel(packed.clone(), rects, ids, grads, denoms, 0.05)
        torch.cuda.synchronize()
        for plain in plains:
            want = plain(packed.clone(), rects, ids, grads, denoms, 0.05)
            assert torch.equal(got.view(bits), want.view(bits)), (step, plain.__name__)
