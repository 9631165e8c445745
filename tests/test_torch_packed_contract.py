"""The contract the packed row write relies on, on the CPU: the trainer's
packed ids, after ``_segment_dedup`` and then "compact"'s ``compact_rows``,
are sorted and every non-first occurrence of an id carries an all-zero
gradient row, so a write may skip a row whose id equals its predecessor's
without reading it (``csrc/rowadam.cu``); and each plain version
(``fused_rowadam_packed_reference``, ``fused_rowadam_packed_bf16_reference``)
leaves the same array whether or not those duplicate rows are removed
first. The ids are ``PackedRows.ids`` of MF's layout (users' rows, then
items', at ``configs/mf_default.json``'s emb 64 and a bias column) drawn
uniformly or from a zipf law, as ``chip_smoke.packed_inputs`` draws them."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from beta_recsys_tpu_torch.core.sparse_optim import PackedRows, _segment_dedup, compact_rows
from beta_recsys_tpu_torch.ops.kernels.rowadam import (
    bias_denominators,
    fused_rowadam_packed_bf16_reference,
    fused_rowadam_packed_reference,
    repack16,
)

N_USERS, N_ITEMS, EMB = 943, 1682, 64
BATCH = 400  # mf_default.json's batch: L = 3 * BATCH packed ids a step


def _mf_layout(bf16):
    roles = {"users": [("user_emb", EMB, 2), ("user_bias", 1, 1)],
             "items_cat": [("item_emb", EMB, 2), ("item_bias", 1, 1)]}
    if bf16:
        roles = {role: specs[:1] for role, specs in roles.items()}
    return PackedRows(roles, {"users": N_USERS, "items_cat": N_ITEMS})


def _step(layout, draw, seed):
    """One step's packed ids and their gradient rows: B user ids and 2B item
    ids, every 7th gradient row zero."""
    rng = np.random.default_rng(seed)

    def ids_of(n, size):
        return (rng.zipf(1.2, size) - 1) % n if draw == "zipf" else rng.integers(0, n, size)

    role_ids = {"users": torch.as_tensor(ids_of(N_USERS, BATCH)),
                "items_cat": torch.as_tensor(ids_of(N_ITEMS, 2 * BATCH))}
    ids, _ = layout.ids(role_ids)
    grads = torch.as_tensor(rng.standard_normal((ids.shape[0], layout.w)), dtype=torch.float32)
    grads[::7] = 0.0
    return ids, grads


def _packed(layout, bf16, seed):
    gen = torch.Generator().manual_seed(seed)
    params, moments = {}, {}
    for name, nd, _, n, _, w in layout.columns:
        shape = (n, w) if nd == 2 else (n,)
        params[name] = torch.randn(shape, generator=gen)
        moments[name] = (0.1 * torch.randn(shape, generator=gen), (0.1 * torch.randn(shape, generator=gen)).abs())
    return (layout.pack16 if bf16 else layout.pack)(params, moments)


def _first(ids):
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    return first


def _assert_contract(raw_ids, raw_grads, ids, grads, capacity=None):
    """Sorted ids; every non-first occurrence's row zero; the first
    occurrences of the first ``capacity`` distinct ids carry their group's
    summed rows, the others zero rows."""
    assert ids.shape == raw_ids.shape and grads.shape == raw_grads.shape
    assert torch.equal(ids, torch.sort(raw_ids).values)
    first = _first(ids)
    assert not grads[~first].any()
    rank = torch.cumsum(first, 0) - 1
    for r in torch.nonzero(first).flatten().tolist():
        group = raw_grads[raw_ids == ids[r]]
        if capacity is not None and rank[r] >= capacity:
            assert not grads[r].any()
        else:
            torch.testing.assert_close(grads[r], group.sum(dim=0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("capacity", [None, 16, 512, 10_000], ids=["unified", "cap16", "cap512", "cap10000"])
@pytest.mark.parametrize("draw", ["uniform", "zipf"])
def test_dedup_then_compact_zeroes_every_duplicate(draw, capacity, seed):
    layout = _mf_layout(bf16=False)
    raw_ids, raw_grads = _step(layout, draw, seed)
    ids, grads = _segment_dedup(raw_ids, raw_grads)
    if capacity is not None:
        grads, dropped = compact_rows(ids, grads, capacity)
        assert int(dropped) == max(0, int(_first(ids).sum()) - capacity)
    _assert_contract(raw_ids, raw_grads, ids, grads, capacity)


@settings(max_examples=60, deadline=None)
@given(raw=st.lists(st.integers(0, 12), min_size=1, max_size=40), w=st.integers(1, 4),
       capacity=st.one_of(st.none(), st.integers(0, 14)), seed=st.integers(0, 2**16))
def test_dedup_then_compact_contract_on_any_ids(raw, w, capacity, seed):
    raw_ids = torch.as_tensor(raw, dtype=torch.int64)
    rng = np.random.default_rng(seed)
    raw_grads = torch.as_tensor(rng.integers(-3, 4, (len(raw), w)), dtype=torch.float32)
    ids, grads = _segment_dedup(raw_ids, raw_grads)
    if capacity is not None:
        grads, _ = compact_rows(ids, grads, capacity)
    _assert_contract(raw_ids, raw_grads, ids, grads, capacity)


@pytest.mark.parametrize("capacity", [None, 16], ids=["unified", "cap16"])
@pytest.mark.parametrize("draw", ["uniform", "zipf"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_plain_versions_ignore_duplicate_rows(bf16, draw, capacity):
    """The plain write of the trainer's rows equals the write of their first
    occurrences alone, bit for bit."""
    layout = _mf_layout(bf16)
    ids, grads = _segment_dedup(*_step(layout, draw, seed=3))
    if capacity is not None:
        grads, _ = compact_rows(ids, grads, capacity)
    packed = _packed(layout, bf16, seed=4)
    plain = fused_rowadam_packed_bf16_reference if bf16 else fused_rowadam_packed_reference
    denoms = bias_denominators(5)
    first = _first(ids)
    want = plain(packed.clone(), layout.rects, ids[first], grads[first], denoms, 0.05)
    got = plain(packed.clone(), layout.rects, ids, grads, denoms, 0.05)
    assert torch.equal(got, want)
    assert not torch.equal(got, packed)


@settings(max_examples=40, deadline=None)
@given(raw=st.lists(st.integers(-3, 160), min_size=1, max_size=60), bf16=st.booleans(),
       capacity=st.one_of(st.none(), st.integers(0, 30)), seed=st.integers(0, 2**16))
def test_plain_versions_ignore_duplicate_rows_any_rects(raw, bf16, capacity, seed):
    """Roles whose columns split differently (8 + 3 against 1 + 10), ids
    outside every table, any duplicates."""
    rects = [(0, 100, 0, 8), (0, 100, 8, 3), (100, 50, 0, 1), (100, 50, 1, 10)]
    gen = torch.Generator().manual_seed(seed)
    p, m = torch.randn(150, 11, generator=gen), 0.1 * torch.randn(150, 11, generator=gen)
    v = (0.1 * torch.randn(150, 11, generator=gen)).abs()
    if bf16:
        packed, plain = repack16(p, m, v), fused_rowadam_packed_bf16_reference
    else:
        packed, plain = torch.cat([p, m, v], dim=1), fused_rowadam_packed_reference
    raw_ids = torch.as_tensor(raw, dtype=torch.int64)
    ids, grads = _segment_dedup(raw_ids, torch.randn(len(raw), 11, generator=gen))
    if capacity is not None:
        grads, _ = compact_rows(ids, grads, capacity)
    first = _first(ids)
    denoms = bias_denominators(2)
    want = plain(packed.clone(), rects, ids[first], grads[first], denoms, 0.05)
    assert torch.equal(plain(packed.clone(), rects, ids, grads, denoms, 0.05), want)
