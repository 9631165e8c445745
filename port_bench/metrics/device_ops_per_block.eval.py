"""Kernels, copies and sets on the device a block of users, over the
profiled ``evaluate()`` passes."""

from harness.readers import device_ops_per


def read(record):
    return device_ops_per(record, record.info.get("blocks_per_call", 1))
