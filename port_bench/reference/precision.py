"""The precision a reference computes its products in.

``tf32=False`` is float32 throughout (the harness turns TF32 off). The
control of the correctness check is the same reference with ``tf32=True``:
every operand of a matrix or dot product rounded to TF32's 10 mantissa bits
(round to nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and the
products accumulated in float32, which is what a TF32 tensor-core product
computes. The rounding is explicit, so the control reads the same on the
CPU and on the card.
"""

import torch


def round_tf32(x):
    """``x`` rounded to TF32; gradients pass through as through the
    identity, so a backward product also takes the rounded operand."""
    bits = x.detach().float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x).detach()


def operand(x, tf32):
    return round_tf32(x) if tf32 else x


def mm(a, b, tf32):
    return torch.matmul(operand(a, tf32), operand(b, tf32))


def dot(a, b, tf32):
    """Row-wise dot products over the last axis."""
    return (operand(a, tf32) * operand(b, tf32)).sum(dim=-1)
