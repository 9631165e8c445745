"""The collectives the JAX package leaves to XLA, over one mesh axis held by
one controller as a list of per-rank tensors (rank k's on its device).

``psum`` adds the parts in rank order on rank 0's device and hands every rank
a copy, so a seed's run repeats bit for bit and every replica holds the same
bits; ``all_gather`` concatenates the parts in rank order on every rank's
device. Ranks that share a device share one result tensor. Both are plain
torch copies and adds: only the ring all-gather is a hand-written kernel
(``ops/kernels/ring_exchange.py``).
"""

import torch


def _spread(value, parts):
    """``value`` on each part's device, computed once per distinct device."""
    copies = {value.device: value}
    for p in parts:
        if p.device not in copies:
            copies[p.device] = value.to(p.device)
    return [copies[p.device] for p in parts]


def psum(parts):
    """[sum of parts] for each rank: ``jax.lax.psum`` over the axis."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return _spread(total, parts)


def all_gather(parts):
    """[concatenation of parts] for each rank: ``jax.lax.all_gather(...,
    tiled=True)`` over the axis."""
    first = parts[0].device
    return _spread(torch.cat([p.to(first) for p in parts]), parts)
