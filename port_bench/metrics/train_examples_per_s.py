"""train_examples_per_s: positives trained over the whole window."""

from harness.readers import rate


def read(record):
    return rate(record, "examples")
