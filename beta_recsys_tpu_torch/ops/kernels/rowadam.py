"""Lazy-Adam row update, in place: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``fused_rowadam`` in ``beta_recsys_tpu/ops/pallas/rowadam.py``
with its contract: ``ids`` (L,) int64 are sorted and duplicates carry all-zero
gradient rows (``core/sparse_optim._segment_dedup``); every row whose gradient
is not all zero updates row ``ids[r]`` of (table, m, v); an all-zero row is
skipped (no moment decay, no write). ``bc`` = (1/(1-b1^t), 1/(1-b2^t)) comes
in as two Python floats rounded to float32 (``bias_corrections``), so no
device value is read on the host. The kernel is ``csrc/rowadam.cu``; its
source note says what bounds it on the H100 and how it is designed.

A CPU tensor goes through the plain version; a CUDA tensor goes through the
kernel or raises.
"""

import ctypes
import functools

import numpy as np
import torch

def bias_corrections(step, b1=0.9, b2=0.999):
    """(1/(1-b1^step), 1/(1-b2^step)) in float32 arithmetic, as the JAX
    package computes them from its float32 step count."""
    one, s = np.float32(1.0), np.float32(step)
    return tuple(float(one / (one - np.float32(b) ** s)) for b in (b1, b2))


def adam_rows(m_rows, v_rows, grads, bc, lr, b1=0.9, b2=0.999, eps=1e-8):
    """(delta, m', v') of gathered rows, in the kernel's order of operations:
    the one copy of the lazy-Adam arithmetic that the plain version and
    ``core/sparse_optim.sparse_adam_row_update`` share."""
    m_new = b1 * m_rows + (1 - b1) * grads
    v_new = b2 * v_rows + (1 - b2) * grads * grads
    delta = -lr * (m_new * bc[0]) / (torch.sqrt(v_new * bc[1]) + eps)
    return delta, m_new, v_new


def fused_rowadam_reference(table, m, v, ids, grads, bc, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The plain version: the same update with torch ops, in place. Its
    boolean selection of the touched rows reads a count on the host."""
    _check(table, m, v, ids, grads)
    touched = (grads != 0).any(dim=1)
    rows = ids[touched]
    delta, m_new, v_new = adam_rows(m[rows], v[rows], grads[touched], bc, lr, b1, b2, eps)
    table[rows] = table[rows] + delta
    m[rows] = m_new
    v[rows] = v_new
    return table, m, v


def fused_rowadam(table, m, v, ids, grads, bc, lr, b1=0.9, b2=0.999, eps=1e-8):
    """Update rows ``ids`` of (table, m, v) in place; returns them. Counts
    its kernel launches in ``fused_rowadam.launches``."""
    if table.device.type == "cpu":
        return fused_rowadam_reference(table, m, v, ids, grads, bc, lr, b1, b2, eps)
    if table.device.type != "cuda":
        raise ValueError(f"fused_rowadam runs on cuda or cpu, not {table.device}")
    _check(table, m, v, ids, grads)
    n_rows, d = table.shape
    fn = _kernel_function()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), m.data_ptr(), v.data_ptr(), ids.data_ptr(),
                 grads.data_ptr(), n_rows, ids.numel(), d,
                 lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, bc[0], bc[1], stream)
    if err != 0:
        raise RuntimeError(f"fused_rowadam launch failed: CUDA error {err}")
    fused_rowadam.launches += 1
    return table, m, v


fused_rowadam.launches = 0


def _check(table, m, v, ids, grads):
    if table.dim() != 2 or m.shape != table.shape or v.shape != table.shape:
        raise ValueError(f"table, m, v must share one (N, d) shape: {table.shape}, {m.shape}, {v.shape}")
    if ids.dim() != 1 or ids.dtype != torch.int64:
        raise TypeError(f"ids must be 1-D int64, got {ids.dtype} of shape {tuple(ids.shape)}")
    if grads.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(f"grads must be (L, d) = ({ids.shape[0]}, {table.shape[1]}), got {tuple(grads.shape)}")
    for name, x in (("table", table), ("m", m), ("v", v), ("ids", ids), ("grads", grads)):
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "ids" and x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")


@functools.cache
def _kernel_function():
    from ._build import load_library

    fn = load_library("rowadam").fused_rowadam
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_float] * 8 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn
