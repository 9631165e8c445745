"""The training window's share (%) of the card's peak: each step's least
time (the larger of its bytes over the HBM rate and its FLOPs over the
float32 peak; bytes bound it) summed over an epoch, over the window's time
an epoch."""

from harness.readers import pairwise_least_s, step_share


def read(record):
    return step_share(record, pairwise_least_s(record))
