"""Generalized matrix factorization: an elementwise-product tower with an
affine output.

Counterpart of ``beta_recsys_tpu/models/gmf.py``: score =
sigmoid((u * i) @ w + b), BCE loss, normal(0, 0.01) embeddings. Parameter
names and layouts follow the JAX params tree (``user_emb``, ``item_emb``,
``affine_w`` as (d, 1), applied as ``x @ w``, and ``affine_b`` (1,)).
"""

import torch
from torch import nn

from .base import RecModel
from .losses import bce_loss
from .mlp import lecun_normal_


class GMF(RecModel):
    batch_kind = "pointwise"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.stddev = float(config.get("stddev", 0.01))
        d, dev = self.emb_dim, self.device
        self.user_emb = nn.Parameter(torch.empty(n_users, d, device=dev))
        self.item_emb = nn.Parameter(torch.empty(n_items, d, device=dev))
        self.affine_w = nn.Parameter(torch.empty(d, 1, device=dev))
        self.affine_b = nn.Parameter(torch.empty(1, device=dev))

    @torch.no_grad()
    def init_weights(self, generator):
        """normal(0, stddev) tables, a LeCun-normal affine weight and a zero
        bias, drawn from a CPU ``torch.Generator`` (the JAX ``init_params``)."""
        for p in (self.user_emb, self.item_emb):
            p.copy_(torch.empty(p.shape).normal_(0.0, self.stddev, generator=generator))
        self.affine_w.copy_(lecun_normal_(torch.empty(self.affine_w.shape), generator))
        self.affine_b.zero_()
        return self

    def score_pairs(self, users, items):
        prod = self.user_emb[users] * self.item_emb[items]
        logits = prod @ self.affine_w + self.affine_b
        return torch.sigmoid(logits[..., 0])

    def loss(self, batch, generator=None):
        """BCE of the pairs' scores against their labels (no dropout)."""
        return bce_loss(self.score_pairs(batch["users"], batch["items"]), batch["labels"])
