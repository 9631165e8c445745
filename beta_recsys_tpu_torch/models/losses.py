"""Shared loss functions (BPR / BCE and the L2 term).

Counterpart of ``beta_recsys_tpu/models/losses.py``: BPR is
-mean(logsigmoid(pos - neg)); its softplus form (LightGCN's) is
mean(softplus(neg - pos)); BCE is binary cross-entropy on probabilities.
"""

import torch
import torch.nn.functional as F


def bpr_loss(pos_scores, neg_scores):
    """Bayesian Personalized Ranking pairwise loss: -mean log sigma(pos - neg)."""
    return -F.logsigmoid(pos_scores - neg_scores).mean()


def softplus_bpr_loss(pos_scores, neg_scores):
    """Softplus form of BPR used by LightGCN: mean softplus(neg - pos)."""
    return F.softplus(neg_scores - pos_scores).mean()


def bce_loss(probs, labels, eps=1e-7):
    """Binary cross-entropy on probabilities (post-sigmoid scores)."""
    p = probs.clamp(eps, 1 - eps)
    return -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p)).mean()


def l2_reg(*tensors, batch_size=None):
    """Sum of squared entries, optionally divided by the batch size."""
    total = sum((t**2).sum() for t in tensors)
    if batch_size is not None:
        total = total / batch_size
    return total
