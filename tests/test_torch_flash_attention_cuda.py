"""On a card: the flash-attention forward and backward CUDA kernels against
their plain versions (dropout masks bit for bit), two runs giving the same
bits, and head dims the kernels do not take raising. Imports nothing of
JAX, so it runs on the card's machine:

    python3 -m pytest --noconftest tests/test_torch_flash_attention_cuda.py -q

(``tests/conftest.py`` configures JAX, which that machine does not have).
Every test skips without a CUDA device.
"""

import pytest
import torch

from beta_recsys_tpu_torch.ops.kernels.flash_attention import (
    flash_causal_attention,
    flash_causal_attention_bwd,
    flash_causal_attention_reference,
)
from beta_recsys_tpu_torch.ops.kernels.philox import dropout_keep_mask

# Kernel against plain version on the same inputs. float32: sums of up to T
# products in other orders, exponents in base 2 (the backward's gradients
# are sums of T terms of size up to ~sqrt(dh)): |d| <= 1e-4 * max(1, |plain|).
# bfloat16: both compute in float32 and round each output once to
# bfloat16, so they may land one bfloat16 step (2^-8 relative) apart:
# |d| <= 2e-2 * max(1, |plain|).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5  # lse is float32 on both sides


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(n, t, dh, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(n, t, dh, generator=gen, device="cuda").to(dtype) for _ in range(4)]


def _assert_close(got, want, dtype, what):
    err = (got.float() - want.float()).abs()
    limit = TOL[dtype] * want.float().abs().clamp(min=1.0)
    assert bool((err <= limit).all()) and bool(torch.isfinite(got.float()).all()), (what, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dh", [16, 32, 64])
# 77, 100, 200: the paths' lengths; 63, 64, 65, 128, 129: the backward's
# 64-row tile edges.
@pytest.mark.parametrize("t", [1, 77, 100, 200, 63, 64, 65, 128, 129])
def test_cuda_kernels_match_plain_versions(t, dh, rate, dtype):
    _cuda()
    q, k, v, do = _inputs(6, t, dh, dtype, seed=t + dh)
    seed = torch.tensor([1234567890123 + t], device="cuda")
    fwd0, bwd0 = flash_causal_attention.launches, flash_causal_attention_bwd.launches
    out, lse = flash_causal_attention(q, k, v, rate, seed)
    dq, dk, dv = flash_causal_attention_bwd(q, k, v, lse, do, rate, seed)
    torch.cuda.synchronize()
    assert (flash_causal_attention.launches, flash_causal_attention_bwd.launches) == (fwd0 + 1, bwd0 + 1)

    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ref, ref_lse = flash_causal_attention_reference(*leaves, rate, seed)
    grads = torch.autograd.grad(ref, leaves, do)
    _assert_close(out, ref, dtype, "out")
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        assert got.dtype == dtype
        _assert_close(got, want, dtype, name)


def _kernel_masks(n, t, dh, rate, seed):
    """The keep masks the forward and the backward kernels applied, read off
    their outputs: with q = 0 every visible probability is 1/(row + 1) > 0,
    so with v (forward) or dout (backward) one-hot over a block of dh keys
    (rows), out[i, j] and dv[j, i] are 0 exactly where entry (i, j) was
    dropped."""
    q = torch.zeros(n, t, dh, device="cuda")
    fwd = torch.zeros(n, t, t, dtype=torch.bool, device="cuda")
    bwd = torch.zeros_like(fwd)
    for c0 in range(0, t, dh):
        onehot = torch.zeros(n, t, dh, device="cuda")
        cols = torch.arange(c0, min(c0 + dh, t), device="cuda")
        onehot[:, cols, cols - c0] = 1.0
        out, lse = flash_causal_attention(q, q, onehot, rate, seed)
        _, _, dv = flash_causal_attention_bwd(q, q, onehot, lse, onehot, rate, seed)
        fwd[:, :, cols] = out[:, :, : len(cols)] != 0
        bwd[:, cols, :] = dv[:, :, : len(cols)].transpose(1, 2) != 0
    return fwd, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("t,dh", [(77, 16), (200, 64)])
def test_cuda_dropout_masks_equal_the_plain_mask_bit_for_bit(t, dh):
    _cuda()
    rate, n = 0.1, 4
    seed = torch.tensor([(1 << 40) + 17], device="cuda")
    fwd, bwd = _kernel_masks(n, t, dh, rate, seed)
    causal = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    want = dropout_keep_mask(seed, n, t, rate) & causal
    assert torch.equal(fwd, want) and torch.equal(bwd, want)
    kept, pairs = int(want.sum()), n * t * (t + 1) // 2
    sigma = (pairs * rate * (1 - rate)) ** 0.5
    assert abs(kept - pairs * (1 - rate)) <= 5 * sigma


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_kernels_repeat_bit_for_bit(rate):
    """No atomics: every output element has one owner, so runs repeat."""
    _cuda()
    q, k, v, do = _inputs(256, 100, 32, torch.float32, seed=3)
    seed = torch.tensor([99], device="cuda")
    first = flash_causal_attention(q, k, v, rate, seed)
    first_grads = flash_causal_attention_bwd(q, k, v, first[1], do, rate, seed)
    for _ in range(3):
        again = flash_causal_attention(q, k, v, rate, seed)
        grads = flash_causal_attention_bwd(q, k, v, again[1], do, rate, seed)
        assert all(torch.equal(a, b) for a, b in zip((*first, *first_grads), (*again, *grads)))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 24, 48, 128])
def test_cuda_other_head_dims_raise(dh):
    _cuda()
    q, k, v, do = _inputs(2, 5, dh, torch.float32, seed=0)
    with pytest.raises(ValueError, match="head dims"):
        flash_causal_attention(q, k, v)
    lse = torch.zeros(2, 5, 1, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        flash_causal_attention_bwd(q, k, v, lse, do)
