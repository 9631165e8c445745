"""Ring all-gather of one block per rank: the CUDA kernel's wrapper, its
plain PyTorch version and its autograd function.

Counterpart of ``ring_allgather`` in
``beta_recsys_tpu/ops/pallas/ring_exchange.py``. There it runs inside
``shard_map``, one block per shard of a mesh axis; here one controller holds
the axis's blocks as a list, rank r's block on rank r's device, and gets back
the list of the ranks' (n, C, d) outputs, block s of each from rank s. With
one rank nothing is launched (``x[None]``), as in the JAX package. The
gradient is the reduce-scatter: rank r's block gets the sum over ranks of
their cotangent's block r, added in rank order (the JAX package's ``psum`` and
slice; torch ops, not a kernel).

The kernels are in ``csrc/ring_allgather.cu``; its source note says how
they are designed and what bounds them. When every rank lives on one card
(a mesh that repeats one device), one launch of a copy kernel fills one
(n, n, C, d) tensor whose n views are returned. Across cards, one launch per
card of a one-shot kernel stores each block into every peer's output
through peer pointers, enabled once per set of devices for every pair;
ranks that share a card run in one launch. CPU blocks go through the plain
version; CUDA blocks go through a kernel or raise.
"""

import ctypes
import functools

import torch

MAX_RANKS = 16
FLAG_STRIDE = 64  # the most CTAs one rank's part of a call may use
CTA_BYTES = 16384  # bytes of a block each CTA moves, before the cap


def ring_allgather_reference(blocks):
    """The plain version: each rank's (n, C, d) output formed by the ring's own
    n-1 hops, copying block (r - i) mod n from rank r to rank r+1 at hop i."""
    n = len(blocks)
    outs = [torch.empty((n, *b.shape), dtype=b.dtype, device=b.device) for b in blocks]
    for r, b in enumerate(blocks):
        outs[r][r].copy_(b)
    for i in range(n - 1):
        for r in range(n):
            s = (r - i) % n
            outs[(r + 1) % n][s].copy_(outs[r][s])
    return outs


def ring_allgather(blocks):
    """All-gather one (C, d) block per rank around the ring of their devices.
    Returns n tensors of shape (n, C, d), rank r's on rank r's device, block s
    of each equal to ``blocks[s]`` (on one card, views of one (n, n, C, d)
    tensor). Differentiable. Counts the calls that reach the kernels in
    ``ring_allgather.calls`` and their launches (one per distinct device of
    a call) in ``ring_allgather.launches``, and reports each call to the
    collectives' recorder (``parallel/collectives.py``) as an all-gather of
    n blocks, its backward as a reduce-scatter of one."""
    blocks = list(blocks)
    if len(blocks) == 1:
        return [blocks[0][None]]
    _record("all_gather", len(blocks) * blocks[0].numel() * blocks[0].element_size())
    if torch.is_grad_enabled() and any(b.requires_grad for b in blocks):
        return list(_RingAllGather.apply(*blocks))
    return _forward(blocks)


ring_allgather.calls = 0
ring_allgather.launches = 0


def _record(kind, nbytes):
    from ...parallel.collectives import record  # imported here: the parallel package imports this module

    record(kind, nbytes)


def _forward(blocks):
    devices = tuple(b.device for b in blocks)
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return ring_allgather_reference(blocks)
    if kinds != {"cuda"}:
        raise ValueError(f"ring_allgather runs on cuda or cpu blocks, all on one kind, not {sorted(kinds)}")
    return _launch(blocks, devices)


class _RingAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *blocks):
        ctx.devices = [b.device for b in blocks]
        return tuple(_forward(list(blocks)))

    @staticmethod
    def backward(ctx, *grads):
        first = next(g for g in grads if g is not None)
        _record("reduce_scatter", first[0].numel() * first.element_size())
        out = []
        for r, device in enumerate(ctx.devices):
            total = None
            for g in grads:
                if g is not None:
                    part = g[r].to(device)
                    total = part if total is None else total + part
            out.append(total)
        return tuple(out)


def _check(blocks):
    n = len(blocks)
    if n > MAX_RANKS:
        raise ValueError(f"ring_allgather takes at most {MAX_RANKS} ranks, got {n}")
    first = blocks[0]
    if first.dim() != 2:
        raise ValueError(f"blocks must be (C, d), got shape {tuple(first.shape)}")
    row_bytes = first.shape[1] * first.element_size()
    if row_bytes % 16:
        raise ValueError(f"a block row must be a multiple of 16 bytes (the kernel moves 16-byte vectors); "
                         f"got {first.shape[1]} x {first.element_size()} bytes")
    for r, b in enumerate(blocks):
        if b.shape != first.shape or b.dtype != first.dtype:
            raise ValueError(f"block {r} is {tuple(b.shape)} {b.dtype}, block 0 {tuple(first.shape)} {first.dtype}")
        if not b.is_contiguous() or b.data_ptr() % 16:
            raise ValueError(f"block {r} must be contiguous and 16-byte aligned")


class _RingCall(ctypes.Structure):
    """The C side's ``RingCall`` (``csrc/ring_allgather.cu``), field for field."""

    _fields_ = [
        ("x", ctypes.c_void_p * MAX_RANKS),
        ("out", ctypes.c_void_p * MAX_RANKS),
        ("flags", ctypes.c_void_p * MAX_RANKS),
        ("streams", ctypes.c_void_p * MAX_RANKS),
        ("devs", ctypes.c_int * MAX_RANKS),
        ("n_local", ctypes.c_int * MAX_RANKS),
        ("ranks", ctypes.c_int * MAX_RANKS),
        ("group", ctypes.c_int * MAX_RANKS),
        ("n", ctypes.c_int),
        ("n_launch", ctypes.c_int),
        ("n_ctas", ctypes.c_int),
        ("flag_stride", ctypes.c_int),
        ("block_vecs", ctypes.c_longlong),
        ("epoch", ctypes.c_uint),
    ]


class _Ring:
    """One set of devices (rank r on ``devices[r]``) and everything of its
    calls that does not change between them: the launches (one per distinct
    device), the C call's argument struct, and, when the ranks span several
    cards, each rank's flag words (allocated and zeroed once), peer access
    for every ordered pair of the cards, and the call counter that gives
    each call its epoch. A call only writes its pointers, streams and sizes
    into the struct."""

    def __init__(self, devices):
        lib = _library()
        n = len(devices)
        self.local = {}
        for r, device in enumerate(devices):
            self.local.setdefault(device, []).append(r)
        self.loopback = len(self.local) == 1
        call = self.call = _RingCall()
        call.n, call.n_launch, call.flag_stride = n, len(self.local), FLAG_STRIDE
        order = [r for ranks in self.local.values() for r in ranks]
        for l, (device, ranks) in enumerate(self.local.items()):
            call.devs[l], call.n_local[l] = device.index, len(ranks)
            for r in ranks:
                call.group[r] = l
        for i, r in enumerate(order):
            call.ranks[i] = r
        self.max_ctas = FLAG_STRIDE
        if not self.loopback:
            cards = list(self.local)
            for device in cards:
                for peer in cards:
                    if peer != device:
                        err = lib.ring_enable_peer(device.index, peer.index)
                        if err:
                            raise RuntimeError(
                                f"ring_allgather: no peer access from cuda:{device.index} to cuda:{peer.index} "
                                f"(CUDA error {err}); the kernel stores through peer pointers and has no "
                                "host-staged path"
                            )
            for device, ranks in self.local.items():
                resident = ctypes.c_int(0)
                err = lib.ring_resident_ctas(device.index, ctypes.byref(resident))
                if err:
                    raise RuntimeError(f"ring_allgather: occupancy query on cuda:{device.index} failed: CUDA error {err}")
                self.max_ctas = min(self.max_ctas, resident.value // len(ranks))
            if self.max_ctas < 1:
                raise RuntimeError(f"ring_allgather: {devices} cannot hold a cooperative launch of every rank")
            self.flags = [torch.zeros((2 * n, FLAG_STRIDE), dtype=torch.int32, device=d) for d in devices]
            for device in cards:
                torch.cuda.synchronize(device)  # zeroed before any peer writes a flag
            for r, f in enumerate(self.flags):
                call.flags[r] = f.data_ptr()
        self.call_ptr = ctypes.addressof(call)
        self.epoch = 0


_RINGS = {}


def _launch(blocks, devices):
    _check(blocks)
    n = len(blocks)
    ring = _RINGS.get(devices)
    if ring is None:
        ring = _RINGS[devices] = _Ring(devices)
    first = blocks[0]
    if ring.loopback:  # one tensor holds every rank's output
        outs = torch.empty((n, n, *first.shape), dtype=first.dtype, device=first.device).unbind(0)
    else:
        outs = [None] * n
        for device, ranks in ring.local.items():
            for r, o in zip(ranks, torch.empty((len(ranks), n, *first.shape), dtype=first.dtype,
                                               device=device).unbind(0)):
                outs[r] = o
    block_bytes = first.numel() * first.element_size()
    if block_bytes == 0:
        return list(outs)
    call = ring.call
    for r in range(n):
        call.x[r] = blocks[r].data_ptr()
        call.out[r] = outs[r].data_ptr()
    # The current stream of every device, read on each call, so that a
    # caller's stream is honoured.
    for l, device in enumerate(ring.local):
        call.streams[l] = torch.cuda.current_stream(device).cuda_stream
    call.block_vecs = block_bytes // 16
    if not ring.loopback:
        call.n_ctas = min(ring.max_ctas, -(-block_bytes // CTA_BYTES))
        ring.epoch += 1
        call.epoch = ring.epoch & 0xFFFFFFFF
    err = _library().ring_allgather(ring.call_ptr)
    if err:
        raise RuntimeError(f"ring_allgather launch on {list(ring.local)} failed: CUDA error {err}")
    ring_allgather.launches += call.n_launch
    ring_allgather.calls += 1
    return list(outs)


@functools.cache
def _library():
    from ._build import load_library

    lib = load_library("ring_allgather")
    lib.ring_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ring_enable_peer.restype = ctypes.c_int
    lib.ring_resident_ctas.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ring_resident_ctas.restype = ctypes.c_int
    lib.ring_allgather.argtypes = [ctypes.c_void_p]
    lib.ring_allgather.restype = ctypes.c_int
    return lib
