"""Share (%) of the profiled sub-window with no device activity."""

from harness.readers import idle_share


def read(record):
    return idle_share(record)
