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

``RowAdamPacked`` is the row write of the lazy-Adam trainer's packed layouts
(``core/sparse_optim.py``; the JAX package's ``make_sparse_epoch_fn`` with
``row_update`` "unified", "compact" and "unified_bf16", which it leaves to
XLA): every row table in one array, each table a rectangle (row0, n_rows,
col0, width) of it. float32 rows [param|m|v] of stride 3w
(``fused_rowadam_packed``) or int16 rows [p_hi|p_lo|m_bf16|v_bf16] of stride
4w (``fused_rowadam_packed_bf16``: the float32 parameter's two halves and the
moments rounded to bfloat16). One sorted, deduplicated id array of packed
rows and its (L, w) gradients serve all the tables; each table is touched
where its own gradient columns are not all zero. The plain versions follow
the JAX epoch function's order of operations: the bias corrections divide by
``bias_denominators`` (1 - b^t in float32).
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


def bias_denominators(step, b1=0.9, b2=0.999):
    """(1 - b1^step, 1 - b2^step) in float32 arithmetic, as the JAX package's
    packed layouts compute them from its float32 step count."""
    one, s = np.float32(1.0), np.float32(step)
    return tuple(float(one - np.float32(b) ** s) for b in (b1, b2))


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


# -- the packed row layouts --------------------------------------------------------


def unpack16_components(rows16, w):
    """int16 rows [p_hi|p_lo|m|v] (L, 4w) -> float32 (p, m, v): p exact, m
    and v the bfloat16 values widened."""
    halves = torch.stack([rows16[:, w:2 * w], rows16[:, :w]], dim=-1)  # little-endian: low half first
    p = halves.contiguous().view(torch.float32)[..., 0]
    m = rows16[:, 2 * w:3 * w].view(torch.bfloat16).float()
    v = rows16[:, 3 * w:].view(torch.bfloat16).float()
    return p, m, v


def repack16(p, m, v):
    """float32 (p, m, v) (L, w) -> int16 rows [p_hi|p_lo|m|v] (L, 4w): p split
    bit-exactly, m and v rounded to bfloat16 (to nearest even)."""
    halves = p.contiguous().view(torch.int16).view(*p.shape, 2)
    return torch.cat([halves[..., 1], halves[..., 0], m.to(torch.bfloat16).view(torch.int16),
                      v.to(torch.bfloat16).view(torch.int16)], dim=1)


def packed_touched(tables, ids, grads):
    """(L, w) float32 0/1: where row r's id lies in a table's rows and that
    table's gradient columns of row r are not all zero, the table's columns.
    Each role's (a row range's) masks are gated by its id range; roles are
    disjoint, so this also gives the values of the JAX epoch function's
    shortcut for roles of equal column boundaries. Ids outside every table
    get no column."""
    roles = {}
    for row0, n_rows, col0, width in tables:
        roles.setdefault((row0, n_rows), []).append((col0, width))
    nonzero = grads != 0
    in_role = {key: ((ids >= key[0]) & (ids < key[0] + key[1]))[:, None] for key in roles}

    def blocks(cols):
        mask = torch.zeros_like(grads)
        for col0, width in cols:
            mask[:, col0:col0 + width] = nonzero[:, col0:col0 + width].any(dim=1, keepdim=True).to(grads.dtype)
        return mask

    mask = torch.zeros_like(grads)
    for key, cols in roles.items():
        mask = mask + in_role[key] * blocks(cols)
    return mask


def _packed_delta(m_new, v_new, denoms, lr, eps):
    """(-lr * (m'/d1)) / (sqrt(v'/d2) + eps), each division a true one: the
    denominators go in as 0-d tensors, since torch on CUDA divides by a
    Python scalar as a product with its reciprocal."""
    d1, d2 = (torch.tensor(d, dtype=torch.float32, device=m_new.device) for d in denoms)
    return (-lr * (m_new / d1)) / (torch.sqrt(v_new / d2) + eps)


def fused_rowadam_packed_reference(packed, tables, ids, grads, denoms, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The plain version of the float32 packed write, in place: the JAX
    "unified" step's scatter-add of mask*delta, mask*(m' - m) and
    mask*(v' - v) at every id (duplicates add zero rows)."""
    w = packed.shape[1] // 3
    mask = packed_touched(tables, ids, grads)
    safe = ids.clamp(0, packed.shape[0] - 1)
    rows = packed[safe]
    m_r, v_r = rows[:, w:2 * w], rows[:, 2 * w:]
    m_new = b1 * m_r + (1 - b1) * grads
    v_new = b2 * v_r + (1 - b2) * (grads * grads)
    delta = _packed_delta(m_new, v_new, denoms, lr, eps)
    packed.index_add_(0, safe, torch.cat([mask * delta, mask * (m_new - m_r), mask * (v_new - v_r)], dim=1))
    return packed


def fused_rowadam_packed_bf16_reference(packed, tables, ids, grads, denoms, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The plain version of the bfloat16 packed write, in place: the JAX
    "unified_bf16" step. Each first occurrence of an id writes its row
    repacked, its untouched columns with their own bytes; duplicates write
    nothing. Its boolean selection of those rows reads a count on the host."""
    w = packed.shape[1] // 4
    mask = packed_touched(tables, ids, grads) > 0
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    write = first & mask.any(dim=1)
    rows16 = packed[ids[write]]
    g, mask = grads[write], mask[write]
    p, m, v = unpack16_components(rows16, w)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * (g * g)
    delta = _packed_delta(m_new, v_new, denoms, lr, eps)
    packed[ids[write]] = torch.where(mask.repeat(1, 4), repack16(p + delta, m_new, v_new), rows16)
    return packed


class _PackedRect(ctypes.Structure):
    """The C side's ``PackedRect``, field for field."""

    _fields_ = [("row0", ctypes.c_longlong), ("n_rows", ctypes.c_longlong), ("col0", ctypes.c_int),
                ("width", ctypes.c_int)]


class _RowAdamPackedCall(ctypes.Structure):
    """The C side's ``RowAdamPackedCall``, field for field."""

    _fields_ = [
        ("packed", ctypes.c_void_p),
        ("ids", ctypes.c_void_p),
        ("grads", ctypes.c_void_p),
        ("total_rows", ctypes.c_longlong),
        ("n_ids", ctypes.c_int),
        ("w", ctypes.c_int),
        ("count", ctypes.c_int),
        ("t", _PackedRect * MAX_TABLES),
        *((name, ctypes.c_float) for name in ("lr", "b1", "omb1", "b2", "omb2", "eps", "d1", "d2")),
    ]


class RowAdamPacked:
    """Lazy-Adam updates of a packed row array in place, one kernel launch a
    call. ``packed`` is (R, 3w) float32 or, with ``bf16``, (R, 4w) int16,
    contiguous; ``tables`` up to ``MAX_TABLES`` disjoint rectangles (row0,
    n_rows, col0, width) inside it, all checked once, here. A call
    ``group(ids, grads, denoms, lr)`` takes the sorted, deduplicated packed
    ids (L,) int64 and their gradients (L, w) float32 and the bias
    denominators (``bias_denominators``). The kernel relies on that
    contract: every non-first occurrence of an id carries an all-zero
    gradient row (``core/sparse_optim._segment_dedup``, then
    ``compact_rows``), so it never reads a row whose id equals its
    predecessor's; a nonzero gradient there would be dropped, where the
    plain versions would add it. Counts its kernel launches in
    ``fused_rowadam_packed.launches`` or ``fused_rowadam_packed_bf16.launches``."""

    def __init__(self, packed, tables, bf16=False, b1=0.9, b2=0.999, eps=1e-8):
        self.packed, self.tables, self.bf16 = packed, [tuple(int(x) for x in t) for t in tables], bf16
        parts = 4 if bf16 else 3
        dtype = torch.int16 if bf16 else torch.float32
        if packed.dim() != 2 or packed.shape[1] % parts or packed.dtype != dtype or not packed.is_contiguous():
            raise ValueError(f"packed must be a contiguous (R, {parts}w) {dtype} array, got {packed.dtype} "
                             f"{tuple(packed.shape)}")
        self.w = packed.shape[1] // parts
        if not 1 <= len(self.tables) <= MAX_TABLES:
            raise ValueError(f"a packed call holds 1 to {MAX_TABLES} tables, not {len(self.tables)}")
        cells = []
        for row0, n_rows, col0, width in self.tables:
            if row0 < 0 or n_rows < 0 or row0 + n_rows > packed.shape[0] or col0 < 0 or width < 0 \
                    or col0 + width > self.w:
                raise ValueError(f"table {(row0, n_rows, col0, width)} lies outside the packed "
                                 f"({packed.shape[0]}, {self.w}) rows")
            cells.append((row0, row0 + n_rows, col0, col0 + width))
        for i, a in enumerate(cells):
            for b in cells[i + 1:]:
                if a[0] < b[1] and b[0] < a[1] and a[2] < b[3] and b[2] < a[3]:
                    raise ValueError(f"two tables of a packed call overlap: {a}, {b} (rows, columns)")
        self.b1, self.b2, self.eps = b1, b2, eps
        self.device = packed.device
        self.counter = fused_rowadam_packed_bf16 if bf16 else fused_rowadam_packed
        if self.device.type == "cpu":
            self._call = None
        elif self.device.type == "cuda":
            self._fn = _packed_function("fused_rowadam_packed_bf16" if bf16 else "fused_rowadam_packed")
            self._call = _RowAdamPackedCall(packed=packed.data_ptr(), total_rows=packed.shape[0], w=self.w,
                                            count=len(self.tables), b1=b1, omb1=1.0 - b1, b2=b2, omb2=1.0 - b2,
                                            eps=eps)
            for slot, (row0, n_rows, col0, width) in zip(self._call.t, self.tables):
                slot.row0, slot.n_rows, slot.col0, slot.width = row0, n_rows, col0, width
        else:
            raise ValueError(f"fused_rowadam_packed runs on cuda or cpu, not {self.device}")

    def __call__(self, ids, grads, denoms, lr):
        _check_rows(self.packed[:, :self.w], ids, grads)
        if self._call is None:
            plain = fused_rowadam_packed_bf16_reference if self.bf16 else fused_rowadam_packed_reference
            return plain(self.packed, self.tables, ids, grads, denoms, lr, self.b1, self.b2, self.eps)
        call = self._call
        call.ids, call.grads, call.n_ids = ids.data_ptr(), grads.data_ptr(), ids.shape[0]
        call.lr, call.d1, call.d2 = lr, denoms[0], denoms[1]
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._fn(ctypes.byref(call), self.device.index, stream)
        if err != 0:
            raise RuntimeError(f"{self.counter.__name__} launch failed: CUDA error {err}")
        self.counter.launches += 1
        return self.packed


def fused_rowadam_packed(packed, tables, ids, grads, denoms, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The float32 packed write of ``tables`` (rectangles of ``packed``) at
    ``ids`` in place, in one launch; returns ``packed``. Checks everything on
    every call: a trainer builds a ``RowAdamPacked`` once an epoch instead."""
    return RowAdamPacked(packed, tables, False, b1, b2, eps)(ids, grads, denoms, lr)


fused_rowadam_packed.launches = 0


def fused_rowadam_packed_bf16(packed, tables, ids, grads, denoms, lr, b1=0.9, b2=0.999, eps=1e-8):
    """``fused_rowadam_packed`` on int16 [p_hi|p_lo|m_bf16|v_bf16] rows."""
    return RowAdamPacked(packed, tables, True, b1, b2, eps)(ids, grads, denoms, lr)


fused_rowadam_packed_bf16.launches = 0


@functools.cache
def _packed_function(name):
    from ._build import load_library

    fn = getattr(load_library("rowadam"), name)
    fn.argtypes = [ctypes.POINTER(_RowAdamPackedCall), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
