"""The flash-attention kernel's plain version against the JAX Pallas kernel
(interpret mode on the CPU), the wrapper's dispatch, and on a card the CUDA
kernel against its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beta_recsys_tpu.ops.attention import causal_mha as jax_causal_mha
from beta_recsys_tpu.ops.pallas.flash_attention import _flash_call
from beta_recsys_tpu_torch.ops.attention import causal_mha
from beta_recsys_tpu_torch.ops.kernels.flash_attention import (
    flash_causal_attention,
    flash_causal_attention_reference,
    kernel_route,
)

TOL = 2e-5  # float32, summed in other orders on the two sides


def _qkv(n, t, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((n, t, dh)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("n,t", [(8, 1), (3, 7), (4, 48)])
def test_plain_version_matches_pallas_kernel(n, t):
    q, k, v = _qkv(n, t, 32, seed=t)
    want_out, want_lse = _flash_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.0, jnp.zeros((1,), jnp.int32)
    )
    out, lse = flash_causal_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.shape == (n, t, 32) and out.dtype == torch.float32
    assert lse.shape == (n, t, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=TOL, atol=TOL)


def test_plain_version_keeps_bf16_output_type():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(2, 9, 32, seed=1))
    out, lse = flash_causal_attention(q, k, v)
    ref, ref_lse = flash_causal_attention_reference(q.float(), k.float(), v.float())
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out, ref.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)


def test_dispatch_routes_cuda_to_kernel_and_cpu_to_plain():
    assert kernel_route(torch.device("cuda"), 0.0) == "kernel"
    assert kernel_route(torch.device("cuda", 0), 0.0) == "kernel"
    assert kernel_route(torch.device("cpu"), 0.0) == "plain"
    with pytest.raises(ValueError):
        kernel_route(torch.device("meta"), 0.0)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_dropout_rate_raises(device):
    """A dropout rate outside [0, 1) raises on either device; a rate inside
    it takes the device's route."""
    for rate in (-0.1, 1.0, 1.5):
        with pytest.raises(ValueError, match="dropout"):
            kernel_route(torch.device(device), rate)
    assert kernel_route(torch.device(device), 0.1) == ("kernel" if device == "cuda" else "plain")
    if device == "cpu":
        q = torch.zeros(1, 2, 32)
        with pytest.raises(ValueError, match="dropout"):
            flash_causal_attention(q, q, q, rate=1.0)


@pytest.mark.parametrize("fused", [True, False])
def test_causal_mha_matches_reference(fused):
    B, T, D, H = 3, 11, 64, 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    ws = [(rng.standard_normal((D, D)) / 8).astype(np.float32) for _ in range(4)]
    want = jax_causal_mha(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), H, *map(jnp.asarray, ws), fused=fused)
    xt = torch.from_numpy(x)
    got = causal_mha(xt, xt, xt, H, *map(torch.from_numpy, ws), fused=fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 77, 100, 200])
def test_cuda_kernel_matches_plain_version(dtype, t):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(t)
    q, k, v = (torch.randn(64, t, 32, generator=gen, device="cuda").to(dtype) for _ in range(3))
    before = flash_causal_attention.launches
    out, lse = flash_causal_attention(q, k, v)
    assert flash_causal_attention.launches == before + 1
    ref, ref_lse = flash_causal_attention_reference(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5)
    else:  # one bfloat16 rounding step apart at most
        assert ((out.float() - ref.float()).abs() <= 2e-2 * ref.float().abs().clamp(min=1)).all()
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=2e-2)
