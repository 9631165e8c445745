"""Roofline share (%) of the flash forward kernel in training (one launch a
block a step): its bound at the step's (batch * heads, maxlen, head dim)
over its profiled device time."""

from arith import bounds
from harness.readers import kernel_share


def read(record):
    return kernel_share(record, r"flash_fwd_kernel", r"flash_fwd_kernel", record.info.get("flash"),
                        bounds.attention_fwd)
