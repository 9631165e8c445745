"""Adam as the two optimizers of the benchmark's training cells state it.

``adam`` is optax's / torch's Adam (betas 0.9, 0.999, eps 1e-8 outside the
square root of the bias-corrected second moment). ``lazy_adam`` is the
lazy (TF-style) Adam of row tables: the step count is global, and only rows
whose summed gradient has a nonzero entry move, with ``eps`` added to the
square root of the bias-corrected second moment, and the bias corrections
1 / (1 - b^step) worked out in float32 from float32 betas and a float32
step count, as the JAX package's lazy Adam defines them (1 - float32(0.999)
is 0.00099998713, so the second moment's correction reads 1000.0129 at the
first step, not 1000). Both update in place.
"""

import math

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


@torch.no_grad()
def adam(p, g, m, v, step, lr):
    m.mul_(B1).add_(g, alpha=1 - B1)
    v.mul_(B2).addcmul_(g, g, value=1 - B2)
    denom = v.sqrt() / math.sqrt(1 - B2**step) + EPS
    p.sub_(lr / (1 - B1**step) * m / denom)


@torch.no_grad()
def lazy_adam(p, g, m, v, step, lr):
    one_d = p.dim() == 1
    p2, g2, m2, v2 = (x[:, None] if one_d else x for x in (p, g, m, v))
    rows = (g2 != 0).any(dim=1).nonzero().flatten()
    gr = g2[rows]
    m_new = B1 * m2[rows] + (1 - B1) * gr
    v_new = B2 * v2[rows] + (1 - B2) * gr * gr
    one, t = np.float32(1.0), np.float32(step)
    c1, c2 = (float(one / (one - np.float32(b) ** t)) for b in (B1, B2))
    m_hat = m_new * c1
    v_hat = v_new * c2
    p2[rows] = p2[rows] - lr * m_hat / (torch.sqrt(v_hat) + EPS)
    m2[rows] = m_new
    v2[rows] = v_new
