"""Roofline share (%) of the lazy-Adam row write (``rowadam_kernel``, one
launch a step for both embedding tables): the bound of each profiled step's
touched rows and ids over the kernel's profiled device time."""

from arith import bounds
from harness.readers import kernel_share


def read(record):
    info = record.info
    if "touched" not in info:
        return None
    B, d = info["batch_size"], info["emb_dim"]
    shapes = [(u, i) for u, i in (info["touched"][b] for b in info.get("profiled_batches", []))]
    return kernel_share(record, r"\browadam_kernel", r"\browadam_kernel",
                        [((u, B), (i, 2 * B)) for u, i in shapes], lambda *tables: bounds.rowadam(tables, d))
