"""Kernels, copies and sets on the device a training step, over the
profiled steps."""

from harness.readers import device_ops_per


def read(record):
    return device_ops_per(record)
