"""Collective byte counts of one call (counterpart of
``beta_recsys_tpu/parallel/comm_analysis.py``).

The JAX package reads a compiled program's collectives from its HLO. One
controller issues the port's collectives itself, so ``collective_bytes``
runs the function once under ``collectives.recording()`` and returns what
that call issued, in the JAX layout: ``{kind: {"calls", "bytes"}}``, bytes
being each collective's result on one device, summed over its calls (per
device, per call). A step loop of S steps counts S times a step's
collectives, where the JAX count, read from a compiled scan, counts one.
``estimate_link_bytes`` turns those into the bytes each link of a ring
moves, as in the JAX package.
"""

from .collectives import recording


def collective_bytes(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and count its collectives:
    {kind: {"calls": int, "bytes": int}}."""
    with recording() as counts:
        fn(*args, **kwargs)
    return {kind: dict(entry) for kind, entry in counts.items()}


def estimate_link_bytes(counts, axis_size):
    """Per-link byte estimate for a ring of ``axis_size`` devices.

    ring all-gather: result*(n-1)/n per link; all-reduce = reduce-scatter +
    all-gather: 2*(n-1)/n; all-to-all: result*(n-1)/n (each shard except own
    crosses once); collective-permute: full result.
    """
    n = max(axis_size, 1)
    factor = {
        "all_gather": (n - 1) / n,
        "reduce_scatter": (n - 1) / n,
        "all_reduce": 2 * (n - 1) / n,
        "all_to_all": (n - 1) / n,
        "collective_permute": 1.0,
    }
    return {kind: int(v["bytes"] * factor.get(kind, 1.0)) for kind, v in counts.items()}
