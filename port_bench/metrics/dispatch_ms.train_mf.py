"""Host ms to issue one training step (the trainer's ``step``), the device
queue drained before each; the mean over the traced steps."""

from harness.readers import dispatch_ms


def read(record):
    return dispatch_ms(record)
