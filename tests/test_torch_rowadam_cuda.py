"""On a card: the ``fused_rowadam`` CUDA kernel against its plain version,
and the segment dedup repeating bit for bit. Imports nothing of JAX, so it
runs on the card's machine:

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
    fused_rowadam,
    fused_rowadam_reference,
)

# As tests/test_rowadam_kernel.py holds the JAX kernel; the card's kernel
# contracts the same float32 arithmetic into FMAs.
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
    model = MF({"emb_dim": 8, "loss": "bpr"}, 10, 12, device="cuda")
    arrays = types.SimpleNamespace(users=np.arange(10), items=np.arange(10))
    trainer = SparseEpochTrainer(model, arrays, 4, None, 0.05, None, row_update="auto")
    assert trainer.row_update == "fused"
