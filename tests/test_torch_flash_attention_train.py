"""The flash-attention training path of the port on the CPU: the plain
forward and backward against the JAX Pallas kernels (interpret mode) and
``jax.grad`` of the einsum formula, dropout with a given mask, the Philox
mask itself, and the autograd function at every head dim the kernels take.
The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_flash_attention_cuda.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beta_recsys_tpu.ops.pallas.flash_attention import _flash_bwd, _flash_call, _flash_fwd
from beta_recsys_tpu_torch.ops.kernels import flash_attention as fa
from beta_recsys_tpu_torch.ops.kernels.flash_attention import (
    KERNEL_HEAD_DIMS,
    FlashCausalAttention,
    _check_kernel_inputs,
    flash_causal_attention,
    flash_causal_attention_bwd,
    flash_causal_attention_bwd_reference,
    flash_causal_attention_reference,
)
from beta_recsys_tpu_torch.ops.kernels.philox import dropout_keep_mask, keep_threshold, philox4x32_10

FWD_TOL = 2e-5  # float32, summed in other orders (tests/test_flash_attention.py:37)
PALLAS_BWD_TOL = 1e-5  # the same steps as _bwd_kernel, float32 rounding only
GRAD_TOL = 5e-5  # against jax.grad of the einsum formula, as tests/test_flash_attention.py:55
NEG_INF = -1e30


def _arrays(n, t, dh, seed, count=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, t, dh)).astype(np.float32) for _ in range(count)]


def _einsum_attention(q, k, v, keep=None, rate=0.0):
    """softmax(QK^T/sqrt(dh) + causal) [where(keep, P/(1-r), 0)] V in jnp."""
    T, dh = q.shape[1], q.shape[2]
    logits = jnp.einsum("nqd,nkd->nqk", q, k) / jnp.sqrt(dh)
    logits = jnp.where(jnp.tril(jnp.ones((T, T), bool))[None], logits, NEG_INF)
    probs = jax.nn.softmax(logits, -1)
    if keep is not None:
        probs = jnp.where(keep, probs / (1 - rate), 0.0)
    return jnp.einsum("nqk,nkd->nqd", probs, v)


def _jax_grads(q, k, v, do, keep=None, rate=0.0):
    def loss(q, k, v):
        return jnp.sum(_einsum_attention(q, k, v, keep, rate) * do)

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dh", [16, 32, 64])
def test_forward_matches_pallas_kernel_at_every_head_dim(dh):
    q, k, v = _arrays(3, 19, dh, seed=dh, count=3)
    want_out, want_lse = _flash_call(*map(jnp.asarray, (q, k, v)), 0.0, jnp.zeros((1,), jnp.int32))
    out, lse = flash_causal_attention(*map(torch.from_numpy, (q, k, v)))
    _close(out, want_out, FWD_TOL)
    _close(lse, want_lse, FWD_TOL)


# 1, 7, 77: short and ragged rows; 64, 65, 129: the card kernel's 64-row
# tile edges (one full tile, one row past it, two tiles and one row).
@pytest.mark.parametrize("t", [1, 7, 77, 64, 65, 129])
def test_backward_matches_pallas_kernel_and_jax_grad(t):
    q, k, v, do = _arrays(4, t, 32, seed=t)
    seed = jnp.zeros((1,), jnp.int32)
    _, res = _flash_fwd(*map(jnp.asarray, (q, k, v)), seed, 0.0)
    want_pallas = _flash_bwd(0.0, res, jnp.asarray(do))[:3]
    want_grad = _jax_grads(q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    _, lse = flash_causal_attention(tq, tk, tv)
    got = flash_causal_attention_bwd(tq, tk, tv, lse, tdo)
    for g, wp, wg in zip(got, want_pallas, want_grad):
        _close(g, wp, PALLAS_BWD_TOL)
        _close(g, wg, GRAD_TOL)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_forward_and_backward_match_jax_given_the_mask(monkeypatch, rate):
    """The mask is the one input the two packages cannot share through a
    seed (threefry vs Philox): hand both the same one."""
    n, t, dh = 3, 21, 16
    q, k, v, do = _arrays(n, t, dh, seed=11)
    keep = np.random.default_rng(5).random((n, t, t)) >= rate
    monkeypatch.setattr(fa, "dropout_keep_mask", lambda seed, n_, t_, r: torch.from_numpy(keep))
    seed = torch.zeros(1, dtype=torch.int64)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = FlashCausalAttention.apply(*leaves, seed, rate)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    _close(out, _einsum_attention(*map(jnp.asarray, (q, k, v)), keep, rate), FWD_TOL)
    for g, w in zip(got, _jax_grads(q, k, v, do, keep, rate)):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_autograd_function_at_other_head_dims(dh, rate):
    """The CPU path of ``FlashCausalAttention`` (plain forward, explicit
    plain backward) against autograd through the plain forward, same seed."""
    q, k, v, do = map(torch.from_numpy, _arrays(4, 33, dh, seed=dh))
    seed = torch.tensor([2**40 + 3])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(FlashCausalAttention.apply(*leaves, seed, rate), leaves, do)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref, _ = flash_causal_attention_reference(*ref_leaves, rate, seed)
    want = torch.autograd.grad(ref, ref_leaves, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_bwd_plain_version_keeps_bf16_output_type():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _arrays(2, 9, 32, seed=1))
    _, lse = flash_causal_attention(q, k, v)
    grads = flash_causal_attention_bwd_reference(q, k, v, lse, do)
    assert all(g.dtype == torch.bfloat16 and g.shape == q.shape for g in grads)


# Random123's known-answer vectors for philox4x32 with 10 rounds:
# (counter, key) -> the four output words.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_matches_known_answers(counter, key, want):
    assert tuple(int(w) for w in philox4x32_10(counter, key)) == want


def test_keep_mask_is_a_pure_function_of_seed_n_row_col():
    seed = torch.tensor([(7 << 33) + 12345])
    rate = 0.3
    full = dropout_keep_mask(seed, 5, 30, rate)
    assert full.shape == (5, 30, 30) and full.dtype == torch.bool
    assert torch.equal(full, dropout_keep_mask(seed.clone(), 5, 30, rate))
    # A smaller grid is the corner of the larger one: entries depend on
    # (n, row, col) only, not on the grid's extent.
    assert torch.equal(dropout_keep_mask(seed, 3, 13, rate), full[:3, :13, :13])
    # Entry (n, row, col) is word col % 4 of Philox((col // 4, row, n, 0)).
    s = int(seed)
    words = philox4x32_10((17 // 4, 9, 2, 0), (s & 0xFFFFFFFF, s >> 32))
    assert bool(full[2, 9, 17]) == (int(words[17 % 4]) >= keep_threshold(rate))
    assert not torch.equal(full, dropout_keep_mask(seed + 1, 5, 30, rate))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_is_binomial(rate):
    keep = dropout_keep_mask(torch.tensor([42]), 64, 100, rate)
    n = keep.numel()
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(int(keep.sum()) - n * (1 - rate)) <= 5 * sigma


def test_keep_threshold_is_the_tpu_kernels_rule():
    assert keep_threshold(0.0) == 0 and keep_threshold(0.5) == 2**31
    assert keep_threshold(0.1) == int(0.1 * 2**32) and keep_threshold(1.0 - 1e-12) <= 2**32 - 1


@pytest.mark.parametrize("dh", [8, 48, 128])
def test_kernel_input_check_rejects_other_head_dims(dh):
    """What a CUDA tensor of another head dim meets before any launch (the
    card's test: tests/test_torch_flash_attention_cuda.py)."""
    assert dh not in KERNEL_HEAD_DIMS
    x = torch.zeros(2, 5, dh)
    with pytest.raises(ValueError, match="head dims"):
        _check_kernel_inputs(x, x, x)
