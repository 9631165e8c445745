"""The numbers that decide ``correct``, each held to the cell's limit.

Training: each checked step's loss, the first gradient of every leaf as the
optimizer received it, and every leaf's change over the checked steps. A
leaf's norm is compared as |program's norm - reference's norm| over the
larger of the reference's norm of that leaf and of the median leaf. Leaves
whose reference gradient is under a thousandth of the median leaf's
gradient norm move by round-off alone and are left out of the change.

Evaluation: every metric@k of every pass against the reference's, as an
absolute gap.
"""

import statistics


def norm_gap(program, reference, leaves=None):
    """Worst leaf's |norm gap| over max(reference norm, median reference
    norm); ``program`` and ``reference`` map leaf names to norms."""
    names = list(reference if leaves is None else leaves)
    if not names:
        return 0.0
    median = statistics.median(reference[n] for n in reference)
    return max(abs(program[n] - reference[n]) / max(reference[n], median, 1e-30) for n in names)


def moving_leaves(grad_norms):
    """Leaves whose gradient is at least a thousandth of the median leaf's."""
    median = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= 1e-3 * median]


def training_numbers(program, reference):
    """The numbers of two readings {"losses": [...], "grad_norms": {leaf:
    norm}, "change_norms": {...}, "change_norms_1": {...}}: ``loss_gap``
    (the worst checked step's relative loss gap), ``loss_gap_1`` (the first
    step's), ``grad_norm_gap`` (the first gradients), ``change_norm_gap``
    (the change over every checked step) and ``change_norm_gap_1`` (over the
    first). A cell's limits file names the ones it compares."""
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program["losses"], reference["losses"])]
    moving = moving_leaves(reference["grad_norms"])
    return {
        "loss_gap": max(gaps),
        "loss_gap_1": gaps[0],
        "grad_norm_gap": norm_gap(program["grad_norms"], reference["grad_norms"]),
        "change_norm_gap": norm_gap(program["change_norms"], reference["change_norms"], moving),
        "change_norm_gap_1": norm_gap(program["change_norms_1"], reference["change_norms_1"], moving),
    }


def metric_gap(passes, reference):
    """Largest |program - reference| over every pass and metric@k."""
    if not passes:
        return float("inf")
    gaps = [abs(out[key] - value) if key in out else float("inf")
            for out in passes for key, value in reference.items()]
    return max(g if g == g else float("inf") for g in gaps)


def judge(numbers, limits):
    """(correct, [(name, value, limit)]) of the numbers the cell's
    ``limits`` name: each present, finite and within its limit."""
    rows = [(name, float(numbers.get(name, float("inf"))), float(limit)) for name, limit in limits.items()]
    ok = bool(rows) and all(value == value and value <= limit for _, value, limit in rows)
    return ok, rows
