"""The arithmetic the metric readers (``metrics/<metric>.py``) share. Each
returns None where the run gives it nothing to read (no trace, no device
activity, no such kernel): the harness then leaves the metric out."""

import re

from arith import bounds


def rate(record, unit):
    """Work units of ``unit`` over the whole window's seconds."""
    if record.info.get("unit") != unit or record.window_s <= 0:
        return None
    return record.units / record.window_s


def device_ops_per(record, per_call=1):
    """Device activities (kernels, copies, sets) over the profiled calls,
    each of ``per_call`` steps or blocks."""
    t = record.trace
    if t is None or not t.device or not t.steps:
        return None
    return len(t.device) / (t.steps * per_call)


def idle_share(record):
    t = record.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def dispatch_ms(record):
    if not record.dispatch_s:
        return None
    return 1e3 * sum(record.dispatch_s) / len(record.dispatch_s)


def kernel_share(record, pattern, calls_pattern, shapes, bound_fn):
    """Roofline share (%) of a kernel: the bounds of its calls' shapes over
    the device time of the activities matching ``pattern``; the calls are
    counted by ``calls_pattern`` (one launch a call) and their shapes repeat
    ``shapes`` in order."""
    t = record.trace
    if t is None or not shapes:
        return None
    hits = t.kernels(re.compile(pattern))
    calls = len(t.kernels(re.compile(calls_pattern)))
    if not hits or not calls:
        return None
    bound = sum(bound_fn(*shapes[i % len(shapes)])[0] for i in range(calls))
    return 100.0 * bound / sum(s for _, s in hits)


def step_share(record, least_s_per_call):
    """The window's share (%) of the card's peak: least time of its calls
    over the window's time a call."""
    if record.calls <= 0 or record.window_s <= 0 or least_s_per_call is None:
        return None
    return 100.0 * least_s_per_call / (record.window_s / record.calls)


def pairwise_least_s(record):
    """Least time of one call (an epoch of lazy-Adam steps)."""
    info = record.info
    if "touched" not in info:
        return None
    return sum(bounds.pairwise_step(info["batch_size"], u + i, info["emb_dim"])[0] for u, i in info["touched"])
