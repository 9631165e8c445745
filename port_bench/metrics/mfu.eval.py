"""The evaluation window's share (%) of the card's float32 peak: one
pass's model FLOPs (the scoring product with every item; for a sequence
model the encoder over every context too) over 67 TFLOP/s, over the
window's time a pass."""

from arith import bounds
from harness.readers import step_share


def read(record):
    flops = record.info.get("pass_flops")
    return None if flops is None else step_share(record, bounds.flops_only(flops)[0])
