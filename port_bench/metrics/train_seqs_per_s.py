"""train_seqs_per_s: sequences trained over the whole window."""

from harness.readers import rate


def read(record):
    return rate(record, "sequences")
