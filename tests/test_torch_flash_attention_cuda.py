"""On a card: the flash-attention forward and backward CUDA kernels against
their plain versions (dropout masks bit for bit), saturated rows (lse past
1e7) through both kernels, two runs giving the same bits, and head dims the
kernels do not take raising. Imports nothing of
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


def _dominant_inputs(n, t, dh, dtype, seed, gain=1e7):
    """q, k, v, dout where one key dominates every row: q_i = gain * k_j for
    a random visible key j <= i, so row i's top score stands above the rest
    by ~gain * |k_j|^2 and P is one-hot, with lse past 1e7 (the shipped
    config's lr 0.5 reaches such rows within a few steps). Asserts the gap:
    at least 1,000 in units of the scaled score, so every other P is an
    exact 0 in float32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k, v, do = (torch.randn(n, t, dh, generator=gen, device="cuda") for _ in range(3))
    top = (torch.rand(n, t, generator=gen, device="cuda") * torch.arange(1, t + 1, device="cuda")).long()
    q = gain * torch.gather(k, 1, top[..., None].expand(-1, -1, dh))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    s = torch.matmul(q.double(), k.double().transpose(1, 2)) / dh**0.5
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool, device="cuda").tril(), -float("inf"))
    if t > 1:
        two = s[:, 1:].topk(2, dim=-1).values
        assert float((two[..., 0] - two[..., 1]).min()) > 1e3
    return q, k, v, do


def _kernel_and_plain(q, k, v, do, rate, seed):
    """(out, lse, dq, dk, dv) through the forward and backward kernels, and
    (out, dq, dk, dv) through autograd of the plain forward."""
    out, lse = flash_causal_attention(q, k, v, rate, seed)
    grads = flash_causal_attention_bwd(q, k, v, lse, do, rate, seed)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ref, _ = flash_causal_attention_reference(*leaves, rate, seed)
    want = torch.autograd.grad(ref, leaves, do)
    torch.cuda.synchronize()
    return (out, lse, *grads), (ref.detach(), *want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t,dh", [(77, 16), (100, 32), (200, 64)])
def test_cuda_saturated_rows_match_plain_backward(t, dh, rate, dtype):
    """Rows with lse past 1e7: the forward kernel followed by the backward
    kernel gives finite gradients within TOL of autograd through the plain
    forward. A backward whose P of a row's top key is not exactly 1 (its
    scores or lse rounded otherwise than the forward's) leaves gradients of
    the size of the logits here."""
    _cuda()
    q, k, v, do = _dominant_inputs(4, t, dh, dtype, seed=t)
    seed = torch.tensor([4242 + t], device="cuda")
    (out, lse, *grads), (ref, *want) = _kernel_and_plain(q, k, v, do, rate, seed)
    assert float(lse.min()) > 1e7
    _assert_close(out, ref, dtype, "out")
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        _assert_close(got, w, dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t,dh", [(100, 32), (200, 64)])
def test_cuda_one_dominant_key_gives_no_score_gradient(t, dh, rate):
    """Where one key dominates a row (lse past 1e7), P is one-hot, dS =
    P (dP - D) vanishes and so do dq and dk: exactly through the plain
    versions. Through the kernels dk is exactly 0 and dq is within the
    rounding of D k (the backward forms dq = A - D B in one fmaf). That
    holds only when the backward's P of the top key, recomputed from the
    forward's lse, is exactly 1: the forward must give each score the bits
    the backward recomputes. A forward that summed q.k in another order
    would be off by an ulp of lse (1 or more past 1e7), P of the top key
    e^-1 or so, and dq of the size of D k."""
    _cuda()
    q, k, v, do = _dominant_inputs(4, t, dh, torch.float32, seed=7 * t)
    seed = torch.tensor([777], device="cuda")
    (_, lse, dq, dk, _), (_, want_dq, want_dk, _) = _kernel_and_plain(q, k, v, do, rate, seed)
    assert float(lse.min()) > 1e7
    assert not want_dq.any() and not want_dk.any()
    assert not dk.any()
    d_max = float((do.abs().amax() * v.abs().amax() * dh) / (1 - rate))  # a bound on |D|
    rounding = 2.0**-22 * d_max * float(k.abs().max()) / dh**0.5
    assert float(dq.abs().max()) <= rounding, (float(dq.abs().max()), rounding)


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
