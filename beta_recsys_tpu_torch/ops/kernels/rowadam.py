"""Lazy-Adam row update, in place: the CUDA kernel's wrapper and its plain
PyTorch version, for one table or for several in one launch.

Counterpart of ``fused_rowadam`` in ``beta_recsys_tpu/ops/pallas/rowadam.py``
with its contract: ``ids`` (L,) int64 are sorted and duplicates carry all-zero
gradient rows (``core/sparse_optim._segment_dedup``); every row whose gradient
is not all zero updates row ``ids[r]`` of (table, m, v); an all-zero row is
skipped (no moment decay, no write). ``bc`` = (1/(1-b1^t), 1/(1-b2^t)) comes
in as two Python floats rounded to float32 (``bias_corrections``), so no
device value is read on the host. The kernel is ``csrc/rowadam.cu``; its
source note says what bounds it on the H100 and how it is designed.

``RowAdamTables`` holds up to ``MAX_TABLES`` (table, m, v) triples, checked
once when it is built; each call takes one (ids, grads) pair a table and
updates them all in one launch. ``fused_rowadam_tables`` builds one for a
single call, and ``fused_rowadam`` is the JAX function's counterpart, a group
of one. A CPU tensor goes through the plain version, table by table in order;
a CUDA tensor goes through the kernel or raises.
"""

import ctypes
import functools

import numpy as np
import torch

MAX_TABLES = 8  # csrc/rowadam.cu kMaxTables


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
    _check_table(table, m, v)
    _check_rows(table, ids, grads)
    touched = (grads != 0).any(dim=1)
    rows = ids[touched]
    delta, m_new, v_new = adam_rows(m[rows], v[rows], grads[touched], bc, lr, b1, b2, eps)
    table[rows] = table[rows] + delta
    m[rows] = m_new
    v[rows] = v_new
    return table, m, v


def fused_rowadam_tables_reference(tables, ids, grads, bc, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The grouped plain version: ``fused_rowadam_reference`` of each
    (table, m, v) of ``tables`` with its ids and grads, in order."""
    if len(ids) != len(tables) or len(grads) != len(tables):
        raise ValueError(f"one ids and one grads a table: {len(tables)} tables, {len(ids)} ids, {len(grads)} grads")
    for (table, m, v), i, g in zip(tables, ids, grads):
        fused_rowadam_reference(table, m, v, i, g, bc, lr, b1, b2, eps)
    return tables


class _RowAdamTable(ctypes.Structure):
    """The C side's ``RowAdamTable`` (``csrc/rowadam.cu``), field for field."""

    _fields_ = [
        ("table", ctypes.c_void_p),
        ("m", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("ids", ctypes.c_void_p),
        ("grads", ctypes.c_void_p),
        ("n_rows", ctypes.c_longlong),
        ("n_ids", ctypes.c_int),
        ("d", ctypes.c_int),
    ]


class _RowAdamCall(ctypes.Structure):
    """The C side's ``RowAdamCall``, field for field."""

    _fields_ = [
        ("t", _RowAdamTable * MAX_TABLES),
        ("count", ctypes.c_int),
        *((name, ctypes.c_float) for name in ("lr", "b1", "omb1", "b2", "omb2", "eps", "bc1", "bc2")),
    ]


class RowAdamTables:
    """Lazy-Adam updates of the rows of several (table, m, v) triples, in
    place, in one kernel launch a call.

    The tables and moments are checked once, here: each triple one (N, d)
    float32 shape, contiguous, on one device for all, and no two of the
    group's tensors sharing memory (the kernel updates them all at once).
    A call ``group(ids, grads, bc, lr)`` takes one ids (L,) int64 and one
    grads (L, d) float32 a table, in the order of ``tables``, and checks
    only those. Counts its calls in ``fused_rowadam_tables.calls`` and its
    kernel launches (one a call) in ``fused_rowadam.launches``."""

    def __init__(self, tables, b1=0.9, b2=0.999, eps=1e-8):
        self.tables = [tuple(t) for t in tables]
        if not 1 <= len(self.tables) <= MAX_TABLES:
            raise ValueError(f"a group holds 1 to {MAX_TABLES} tables, not {len(self.tables)}")
        self.device = self.tables[0][0].device
        for table, m, v in self.tables:
            _check_table(table, m, v)
            if table.device != self.device:
                raise ValueError(f"a table is on {table.device}, the first on {self.device}")
        _check_disjoint([x for triple in self.tables for x in triple])
        self.b1, self.b2, self.eps = b1, b2, eps
        if self.device.type == "cpu":
            self._call = None
        elif self.device.type == "cuda":
            self._fn = _kernel_function()
            self._call = _RowAdamCall(count=len(self.tables), b1=b1, omb1=1.0 - b1, b2=b2, omb2=1.0 - b2, eps=eps)
            for slot, (table, m, v) in zip(self._call.t, self.tables):
                slot.table, slot.m, slot.v = table.data_ptr(), m.data_ptr(), v.data_ptr()
                slot.n_rows, slot.d = table.shape
        else:
            raise ValueError(f"fused_rowadam runs on cuda or cpu, not {self.device}")

    def __call__(self, ids, grads, bc, lr):
        if len(ids) != len(self.tables) or len(grads) != len(self.tables):
            raise ValueError(f"one ids and one grads a table: {len(self.tables)} tables, "
                             f"{len(ids)} ids, {len(grads)} grads")
        fused_rowadam_tables.calls += 1
        if self._call is None:
            return fused_rowadam_tables_reference(self.tables, ids, grads, bc, lr, self.b1, self.b2, self.eps)
        call = self._call
        for slot, (table, _, _), i, g in zip(call.t, self.tables, ids, grads):
            _check_rows(table, i, g)
            slot.ids, slot.grads, slot.n_ids = i.data_ptr(), g.data_ptr(), i.shape[0]
        call.lr, call.bc1, call.bc2 = lr, bc[0], bc[1]
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._fn(ctypes.byref(call), self.device.index, stream)
        if err != 0:
            raise RuntimeError(f"fused_rowadam launch failed: CUDA error {err}")
        fused_rowadam.launches += 1
        return self.tables


def fused_rowadam_tables(tables, ids, grads, bc, lr, b1=0.9, b2=0.999, eps=1e-8):
    """Update rows ``ids[i]`` of each ``tables[i]`` = (table, m, v) in place,
    all in one launch; returns ``tables``. Checks everything on every call:
    a trainer builds a ``RowAdamTables`` once instead."""
    return RowAdamTables(tables, b1, b2, eps)(ids, grads, bc, lr)


fused_rowadam_tables.calls = 0


def fused_rowadam(table, m, v, ids, grads, bc, lr, b1=0.9, b2=0.999, eps=1e-8):
    """Update rows ``ids`` of (table, m, v) in place; returns them: a group
    of one. Counts its kernel launches in ``fused_rowadam.launches``."""
    return fused_rowadam_tables([(table, m, v)], [ids], [grads], bc, lr, b1, b2, eps)[0]


fused_rowadam.launches = 0


def _check_table(table, m, v):
    if table.dim() != 2 or m.shape != table.shape or v.shape != table.shape:
        raise ValueError(f"table, m, v must share one (N, d) shape: {table.shape}, {m.shape}, {v.shape}")
    for name, x in (("table", table), ("m", m), ("v", v)):
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")


def _check_rows(table, ids, grads):
    if ids.dim() != 1 or ids.dtype != torch.int64:
        raise TypeError(f"ids must be 1-D int64, got {ids.dtype} of shape {tuple(ids.shape)}")
    if grads.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(f"grads must be (L, d) = ({ids.shape[0]}, {table.shape[1]}), got {tuple(grads.shape)}")
    if grads.dtype != torch.float32:
        raise TypeError(f"grads must be float32, got {grads.dtype}")
    for name, x in (("ids", ids), ("grads", grads)):
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_disjoint(tensors):
    """Raises if two of ``tensors`` (contiguous) share any byte of memory."""
    spans = sorted((x.data_ptr(), x.data_ptr() + x.numel() * x.element_size()) for x in tensors if x.numel())
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError("two tables or moments of a fused_rowadam group share memory")


@functools.cache
def _kernel_function():
    from ._build import load_library

    fn = load_library("rowadam").fused_rowadam_tables
    fn.argtypes = [ctypes.POINTER(_RowAdamCall), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
