"""Roofline share (%) of the flash backward (``flash_bwd_dq_kernel`` and
``flash_bwd_dkdv_kernel``, two launches a call, one call a block a step):
its bound at the step's shape over the two kernels' profiled device time."""

from arith import bounds
from harness.readers import kernel_share


def read(record):
    return kernel_share(record, r"flash_bwd_(dq|dkdv)_kernel", r"flash_bwd_dq_kernel", record.info.get("flash"),
                        bounds.attention_bwd)
