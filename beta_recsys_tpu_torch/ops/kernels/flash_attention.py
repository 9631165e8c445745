"""Causal flash attention, forward and backward: the CUDA kernels' wrappers,
their plain PyTorch versions and the autograd function around them.

Counterpart of ``flash_causal_attention`` in
``beta_recsys_tpu/ops/pallas/flash_attention.py`` (``_fwd_kernel`` through
``_flash_call``, ``_bwd_kernel`` through ``_flash_bwd``), with the same
layouts: q, k, v of shape (N = batch * heads, T, dh) give ``out`` (N, T, dh)
in q's type and ``lse`` (N, T, 1) in float32. Attention dropout at ``rate``
drops probabilities after the softmax by the Philox mask of ``philox.py``,
keyed on ``seed`` (a (1,) int64 device tensor that the kernels read), and
scales kept ones by 1/(1 - rate); the backward regenerates the same mask from
the seed. The kernels are ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``; their source notes say what bounds them on
the H100 and how they are designed.

A CPU tensor goes through the plain versions; a CUDA tensor goes through the
kernels or raises. The kernels take head dims 16, 32 and 64.
"""

import ctypes
import functools

import torch

from .philox import dropout_keep_mask, keep_threshold

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64)  # every head dim of configs/sasrec_default.json's grid
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(q, k):
    """Masked causal scores q k^T / sqrt(dh) in float32."""
    N, T, dh = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) * (1.0 / (dh**0.5))
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    return scores.masked_fill(~causal, NEG_INF)


def _dropped(probs, rate, seed):
    """Dropout of attention probabilities by the Philox mask (identity at 0)."""
    if rate == 0:
        return probs
    keep = dropout_keep_mask(seed, probs.shape[0], probs.shape[1], rate)
    return torch.where(keep, probs * (1.0 / (1.0 - rate)), 0.0)


def flash_causal_attention_reference(q, k, v, rate=0.0, seed=None):
    """softmax(QK^T/sqrt(dh) + causal mask) [dropout] V and the row
    log-sum-exp, in float32 arithmetic: the plain version of the forward
    kernel. Autograd through it is the plain version of the backward's."""
    scores = _scores(q, k)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    s = e.sum(dim=-1, keepdim=True)
    out = torch.matmul(_dropped(e / s, rate, seed), v.float())
    return out.to(q.dtype), m + torch.log(s)


def flash_causal_attention_bwd_reference(q, k, v, lse, do, rate=0.0, seed=None):
    """(dq, dk, dv) in q's type by the TPU kernel's steps (``_bwd_kernel``):
    probabilities recomputed from lse, the mask regenerated from the seed,
    rowsum(dP * P) for the softmax backward; float32 arithmetic."""
    N, T, dh = q.shape
    scale = 1.0 / (dh**0.5)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    probs = torch.exp(_scores(q, k) - lse)
    dp = torch.matmul(dof, vf.transpose(1, 2))
    if rate > 0:
        keep = dropout_keep_mask(seed, N, T, rate)
        inv = 1.0 / (1.0 - rate)
        probs_kept = torch.where(keep, probs * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    else:
        probs_kept = probs
    dv = torch.matmul(probs_kept.transpose(1, 2), dof)
    ds = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(1, 2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def kernel_route(device, rate):
    """"kernel" for a CUDA device, "plain" for the CPU; raises for a rate
    outside [0, 1) and for any other device."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate must lie in [0, 1), not {rate}")
    if device.type == "cuda":
        return "kernel"
    if device.type == "cpu":
        return "plain"
    raise ValueError(f"flash_causal_attention runs on cuda or cpu, not {device}")


def _dropout_args(rate, seed, device):
    """(seed pointer, dropout flag, threshold, keep scale) for a launch."""
    if rate == 0:
        return None, 0, 0, 1.0
    if seed is None or seed.device != device or seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError("attention dropout needs seed: a (1,) int64 tensor on the inputs' device")
    return seed.data_ptr(), 1, keep_threshold(rate), 1.0 / (1.0 - rate)


def flash_causal_attention(q, k, v, rate=0.0, seed=None):
    """(out, lse) of causal attention over (N, T, dh) heads; see the module
    docstring. Counts its kernel launches in ``flash_causal_attention.launches``.
    """
    if kernel_route(q.device, rate) == "plain":
        return flash_causal_attention_reference(q, k, v, rate, seed)
    _check_kernel_inputs(q, k, v)
    seed_ptr, dropout, threshold, keep_scale = _dropout_args(rate, seed, q.device)
    N, T, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((N, T, 1), dtype=torch.float32, device=q.device)
    if N == 0 or T == 0:
        return out, lse
    fn = _kernel_function("flash_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), seed_ptr,
                 N, T, dh, _DTYPE_CODES[q.dtype], dropout, threshold, keep_scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_causal_attention.launches += 1
    return out, lse


flash_causal_attention.launches = 0


def flash_causal_attention_bwd(q, k, v, lse, do, rate=0.0, seed=None):
    """(dq, dk, dv) of ``flash_causal_attention`` given the forward's lse,
    the output gradient ``do`` and the forward's rate and seed: the TPU
    kernel's residuals, without the forward's out. Counts its launches (one
    per call: the two kernels of the backward) in
    ``flash_causal_attention_bwd.launches``."""
    if kernel_route(q.device, rate) == "plain":
        return flash_causal_attention_bwd_reference(q, k, v, lse, do, rate, seed)
    _check_kernel_inputs(q, k, v, do)
    if lse.shape != (*q.shape[:2], 1) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be the forward's contiguous float32 (N, T, 1), not {lse.shape} {lse.dtype}")
    seed_ptr, dropout, threshold, keep_scale = _dropout_args(rate, seed, q.device)
    N, T, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    if N == 0 or T == 0:
        return dq, dk, dv
    delta = torch.empty((N, T), dtype=torch.float32, device=q.device)
    fn = _kernel_function("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), seed_ptr,
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                 N, T, dh, _DTYPE_CODES[q.dtype], dropout, threshold, keep_scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
    flash_causal_attention_bwd.launches += 1
    return dq, dk, dv


flash_causal_attention_bwd.launches = 0


class FlashCausalAttention(torch.autograd.Function):
    """out = causal attention of (q, k, v) at (rate, seed), differentiable in
    q, k and v: the forward saves q, k, v, lse and the seed (the TPU
    kernel's residuals), and the backward runs ``flash_causal_attention_bwd``
    (the kernel on a CUDA tensor, the plain version on a CPU tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate):
        out, lse = flash_causal_attention(q, k, v, rate, seed)
        ctx.save_for_backward(q, k, v, lse, seed)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, seed = ctx.saved_tensors
        # dout arrives through the heads' transpose/reshape: the kernel wants rows.
        dq, dk, dv = flash_causal_attention_bwd(q, k, v, lse, dout.contiguous(), ctx.rate, seed)
        return dq, dk, dv, None, None


def _check_kernel_inputs(q, *others):
    if q.dim() != 3 or any(x.shape != q.shape for x in others):
        raise ValueError(f"q, k, v (and do) must share one (N, T, dh) shape: "
                         f"{[tuple(x.shape) for x in (q, *others)]}")
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in others):
        raise TypeError(f"q, k, v (and do) must be all float32 or all bfloat16: "
                        f"{[x.dtype for x in (q, *others)]}")
    if q.shape[2] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernels take head dims {KERNEL_HEAD_DIMS}, not {q.shape[2]}")
    for x in (q, *others):
        if x.device != q.device:
            raise ValueError(f"an input is on {x.device}, q on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("every input must be contiguous and 16-byte aligned")


@functools.cache
def _kernel_function(name):
    from ._build import load_library

    fn = getattr(load_library(name), name)
    n_ptrs = {"flash_attention_fwd": 6, "flash_attention_bwd": 10}[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
