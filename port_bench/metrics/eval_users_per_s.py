"""eval_users_per_s: users ranked over the full catalog over the whole
window."""

from harness.readers import rate


def read(record):
    return rate(record, "users")
