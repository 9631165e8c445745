"""Causal flash attention, forward: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``flash_causal_attention`` in
``beta_recsys_tpu/ops/pallas/flash_attention.py`` (the forward, ``_fwd_kernel``
through ``_flash_call``), with the same layouts: q, k, v of shape
(N = batch * heads, T, dh) give ``out`` (N, T, dh) in q's type and ``lse``
(N, T, 1) in float32. The kernel is ``csrc/flash_attention_fwd.cu``; its source
note says what bounds it on the H100 and how it is designed.

A CPU tensor goes through the plain version; a CUDA tensor goes through the
kernel or raises. Attention dropout (``rate > 0``) is a training feature and
raises here on either device.
"""

import ctypes

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIM = 32  # the head dim of every served config; the kernel is built for it
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_causal_attention_reference(q, k, v):
    """softmax(QK^T/sqrt(dh) + causal mask) V and the row log-sum-exp, in
    float32 arithmetic: the plain version of the kernel."""
    N, T, dh = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) * (1.0 / (dh**0.5))
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    s = e.sum(dim=-1, keepdim=True)
    out = torch.matmul(e / s, v.float())
    return out.to(q.dtype), m + torch.log(s)


def kernel_route(device, rate):
    """"kernel" for a CUDA device, "plain" for the CPU; raises for what
    neither supports."""
    if rate > 0:
        raise NotImplementedError(
            "attention dropout (rate > 0) comes with the training slice; "
            "serving runs at rate 0"
        )
    if device.type == "cuda":
        return "kernel"
    if device.type == "cpu":
        return "plain"
    raise ValueError(f"flash_causal_attention runs on cuda or cpu, not {device}")


def flash_causal_attention(q, k, v, rate=0.0):
    """(out, lse) of causal attention over (N, T, dh) heads; see the module
    docstring. Counts its kernel launches in ``flash_causal_attention.launches``.
    """
    if kernel_route(q.device, rate) == "plain":
        return flash_causal_attention_reference(q, k, v)
    _check_kernel_inputs(q, k, v)
    N, T, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((N, T, 1), dtype=torch.float32, device=q.device)
    if N == 0 or T == 0:
        return out, lse
    fn = _kernel_function()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 N, T, dh, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_causal_attention.launches += 1
    return out, lse


flash_causal_attention.launches = 0


def _check_kernel_inputs(q, k, v):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (N, T, dh) shape: {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be all float32 or all bfloat16: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[2] != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {KERNEL_HEAD_DIM}, not {q.shape[2]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _kernel_function():
    from ._build import load_library

    fn = load_library("flash_attention_fwd").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
