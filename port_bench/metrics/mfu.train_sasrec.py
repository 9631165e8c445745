"""The training window's share (%) of the card's float32 peak: a step's
model FLOPs (forward, and twice that backward; attention over the causal
half) over 67 TFLOP/s, times the steps of an epoch, over the window's time
an epoch."""

from arith import bounds
from harness.readers import step_share


def read(record):
    info = record.info
    if "step_flops" not in info:
        return None
    return step_share(record, info["steps_per_call"] * bounds.flops_only(info["step_flops"])[0])
