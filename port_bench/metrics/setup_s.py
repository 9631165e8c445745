"""setup_s: process start to the first timed call (inputs and weights made,
the program built, its kernels loaded and warm, the checked calls run)."""


def read(record):
    return record.setup_s
