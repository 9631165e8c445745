"""Roofline share (%) of the flash forward kernel in evaluation (one launch
a block of the encoder a user block): the bounds at each block's (users *
heads, maxlen, head dim) over its profiled device time."""

from arith import bounds
from harness.readers import kernel_share


def read(record):
    return kernel_share(record, r"flash_fwd_kernel", r"flash_fwd_kernel", record.info.get("flash"),
                        bounds.attention_fwd)
