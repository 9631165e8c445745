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

The kernel is ``csrc/ring_allgather.cu``; its source note says how it is
designed and what bounds it. Ranks on other cards are reached through peer
pointers, enabled once per ring; ranks that share a card (a mesh that repeats
a device) run in one launch. CPU blocks go through the plain version; CUDA
blocks go through the kernel or raise.
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
    of each equal to ``blocks[s]``. Differentiable. Counts the calls that reach
    the kernel in ``ring_allgather.calls`` and its launches (one per distinct
    device of a call) in ``ring_allgather.launches``."""
    blocks = list(blocks)
    if len(blocks) == 1:
        return [blocks[0][None]]
    if torch.is_grad_enabled() and any(b.requires_grad for b in blocks):
        return list(_RingAllGather.apply(*blocks))
    return _forward(blocks)


ring_allgather.calls = 0
ring_allgather.launches = 0


def _forward(blocks):
    kinds = {b.device.type for b in blocks}
    if kinds == {"cpu"}:
        return ring_allgather_reference(blocks)
    if kinds != {"cuda"}:
        raise ValueError(f"ring_allgather runs on cuda or cpu blocks, all on one kind, not {sorted(kinds)}")
    return _launch(blocks)


class _RingAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *blocks):
        ctx.devices = [b.device for b in blocks]
        return tuple(_forward(list(blocks)))

    @staticmethod
    def backward(ctx, *grads):
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


class _Ring:
    """One ring of devices (rank r on ``devices[r]``): each rank's flag words,
    allocated and zeroed once, and the call counter that gives each call its
    epoch. Peer access is enabled for every neighbour pair on two devices;
    flags are system-scope only when the ring spans several cards."""

    def __init__(self, devices):
        lib = _library()
        n = len(devices)
        self.local = {}
        for r, device in enumerate(devices):
            self.local.setdefault(device, []).append(r)
        for r, device in enumerate(devices):
            for peer in (devices[(r + 1) % n], devices[(r - 1) % n]):
                if peer != device:
                    err = lib.ring_enable_peer(device.index, peer.index)
                    if err:
                        raise RuntimeError(
                            f"ring_allgather: no peer access from cuda:{device.index} to cuda:{peer.index} "
                            f"(CUDA error {err}); the kernel stores through peer pointers and has no host-staged path"
                        )
        self.max_ctas = FLAG_STRIDE
        for device, ranks in self.local.items():
            resident = ctypes.c_int(0)
            err = lib.ring_resident_ctas(device.index, ctypes.byref(resident))
            if err:
                raise RuntimeError(f"ring_allgather: occupancy query on cuda:{device.index} failed: CUDA error {err}")
            self.max_ctas = min(self.max_ctas, resident.value // len(ranks))
        if self.max_ctas < 1:
            raise RuntimeError(f"ring_allgather: {devices} cannot hold a cooperative launch of every rank")
        self.flags = [torch.zeros((n, FLAG_STRIDE), dtype=torch.int32, device=d) for d in devices]
        for device in self.local:
            torch.cuda.synchronize(device)  # zeroed before any peer writes a flag
        self.flag_ptrs = (ctypes.c_void_p * n)(*(f.data_ptr() for f in self.flags))
        self.n_launch = len(self.local)
        self.launch_devices = (ctypes.c_int * self.n_launch)(*(d.index for d in self.local))
        self.launch_ranks = (ctypes.c_int * n)(*(r for ranks in self.local.values() for r in ranks))
        self.launch_sizes = (ctypes.c_int * self.n_launch)(*(len(ranks) for ranks in self.local.values()))
        self.sys = int(self.n_launch > 1)
        self.epoch = 0


_RINGS = {}


def _launch(blocks):
    _check(blocks)
    n = len(blocks)
    devices = tuple(b.device for b in blocks)
    ring = _RINGS.get(devices)
    if ring is None:
        ring = _RINGS[devices] = _Ring(devices)
    outs = [torch.empty((n, *b.shape), dtype=b.dtype, device=b.device) for b in blocks]
    block_bytes = blocks[0].numel() * blocks[0].element_size()
    if block_bytes == 0:
        return outs
    n_ctas = min(ring.max_ctas, -(-block_bytes // CTA_BYTES))
    ring.epoch += 1
    epoch = ring.epoch & 0xFFFFFFFF
    ptrs = ctypes.c_void_p * n
    x = ptrs(*(b.data_ptr() for b in blocks))
    out = ptrs(*(o.data_ptr() for o in outs))
    streams = (ctypes.c_void_p * ring.n_launch)(*(torch.cuda.current_stream(d).cuda_stream for d in ring.local))
    # One launch per device from one C call: a rank spins until its
    # neighbours have entered, so nothing may wait on the host in between.
    with torch.cuda.device(devices[0]):
        err = _library().ring_allgather(ring.n_launch, ring.launch_devices, streams, ring.launch_ranks,
                                        ring.launch_sizes, x, out, ring.flag_ptrs, n, n_ctas, FLAG_STRIDE,
                                        block_bytes // 16, epoch, ring.sys)
    if err:
        raise RuntimeError(f"ring_allgather launch on {list(ring.local)} failed: CUDA error {err}")
    ring_allgather.launches += ring.n_launch
    ring_allgather.calls += 1
    return outs


@functools.cache
def _library():
    from ._build import load_library

    lib = load_library("ring_allgather")
    lib.ring_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ring_enable_peer.restype = ctypes.c_int
    lib.ring_resident_ctas.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ring_resident_ctas.restype = ctypes.c_int
    int_p, ptr_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    lib.ring_allgather.argtypes = (
        [ctypes.c_int, int_p, ptr_p, int_p, int_p, ptr_p, ptr_p, ptr_p] + [ctypes.c_int] * 3
        + [ctypes.c_longlong, ctypes.c_uint, ctypes.c_int]
    )
    lib.ring_allgather.restype = ctypes.c_int
    return lib
