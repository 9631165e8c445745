"""The collectives the JAX package leaves to XLA, over one mesh axis held by
one controller as a list of per-rank tensors (rank k's on its device).

``psum`` adds the parts in rank order on rank 0's device and hands every rank
a copy, so a seed's run repeats bit for bit and every replica holds the same
bits; ``pmean`` divides that sum by the number of ranks; ``all_gather``
concatenates the parts in rank order on every rank's device. Ranks that
share a device share one result tensor. ``pmean_flat`` is the data-parallel
step's one all-reduce: each rank's loss and gradients flattened into one
buffer, the buffers added in rank order and divided by the number of ranks,
as XLA's single tuple all-reduce of ``pmean((loss, grads))`` moves them. All
are plain torch copies and adds: only the ring all-gather is a hand-written
kernel (``ops/kernels/ring_exchange.py``).

``recording()`` counts the collectives issued inside its block by kind
(``all_reduce``, ``all_gather``, ``reduce_scatter``, ``broadcast``): calls,
and the bytes one device materializes for each call, as
``beta_recsys_tpu/parallel/comm_analysis.py`` counts a compiled program's
collectives. A collective over one rank moves nothing and is not counted.
"""

from contextlib import contextmanager

import torch

_RECORDERS = []


@contextmanager
def recording():
    """Within the block, every collective adds to the yielded
    ``{kind: {"calls", "bytes"}}``."""
    counts = {}
    _RECORDERS.append(counts)
    try:
        yield counts
    finally:
        _RECORDERS.remove(counts)


def record(kind, nbytes):
    """Count one collective of ``kind`` whose result takes ``nbytes`` on
    each device (the ring kernel's wrapper reports here too)."""
    for counts in _RECORDERS:
        entry = counts.setdefault(kind, {"calls": 0, "bytes": 0})
        entry["calls"] += 1
        entry["bytes"] += int(nbytes)


def _nbytes(t):
    return t.numel() * t.element_size()


def _spread(value, parts):
    """``value`` on each part's device, computed once per distinct device."""
    copies = {value.device: value}
    for p in parts:
        if p.device not in copies:
            copies[p.device] = value.to(p.device)
    return [copies[p.device] for p in parts]


def _rank_sum(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def psum(parts):
    """[sum of parts] for each rank: ``jax.lax.psum`` over the axis."""
    if len(parts) > 1:
        record("all_reduce", _nbytes(parts[0]))
    return _spread(_rank_sum(parts), parts)


def pmean(parts):
    """[mean of parts] for each rank: ``jax.lax.pmean`` over the axis (the
    rank-order sum, then one division)."""
    if len(parts) > 1:
        record("all_reduce", _nbytes(parts[0]))
    return _spread(_rank_sum(parts) / len(parts), parts)


def pmean_flat(parts):
    """``pmean`` of each rank's list of tensors (one step's loss and
    gradients) through ONE flat buffer a rank: returns the list of means, as
    views of rank 0's buffer, where the optimizer steps. One all-reduce of
    the buffer's bytes is counted."""
    mean = pmean([torch.cat([t.reshape(-1) for t in tensors]) for tensors in parts])[0]
    out, start = [], 0
    for t in parts[0]:
        out.append(mean[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


def all_gather(parts):
    """[concatenation of parts] for each rank: ``jax.lax.all_gather(...,
    tiled=True)`` over the axis."""
    first = parts[0].device
    gathered = torch.cat([p.to(first) for p in parts])
    if len(parts) > 1:
        record("all_gather", _nbytes(gathered))
    return _spread(gathered, parts)
