"""Triple2vec: a skip-gram over (user, item, item) basket triples.

Counterpart of ``beta_recsys_tpu/models/triple2vec.py``: a user table and
two item tables (with ``use_bias``, the default, the second is tied to the
first: ``item_emb2`` still exists, receives no gradient and keeps zero
optimizer moments), U(-0.01, 0.01) at initialisation, zero biases. For each
of (u | i1 + i2), (i1 | u + i2) and (i2 | u + i1) the loss takes
log sigmoid(center . context + center bias) and log sigmoid(-(negative .
center + negative bias)) over ``n_neg`` drawn negatives of the center's
kind; their negated sum over 3 * B. Scoring is u . (it1 + it2) / 2.

The initial products are ~1e-4, so they want full float32: the JAX package
asks for HIGHEST precision on its TPU, and the port keeps TF32 off on the
card (``device.fp32_matmuls``) in training as in serving.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .base import RecModel


def skipgram(center, context, center_bias, neg, neg_bias):
    """-(sum log sigmoid(center . context + b) + sum log sigmoid(-(neg .
    center + b_neg))): center (B, D), context (B, D), neg (B, n_neg, D)."""
    pos = F.logsigmoid((center * context).sum(dim=-1) + center_bias)
    neg_dots = torch.einsum("bnd,bd->bn", neg, center) + neg_bias
    return -(pos.sum() + F.logsigmoid(-neg_dots).sum())


class Triple2vec(RecModel):
    batch_kind = "triple"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.n_neg = int(config.get("n_neg", 5))
        self.tie_items = bool(config.get("use_bias", True))
        d, dev = self.emb_dim, self.device
        self.user_emb = nn.Parameter(torch.empty(n_users, d, device=dev))
        self.item_emb1 = nn.Parameter(torch.empty(n_items, d, device=dev))
        self.item_emb2 = nn.Parameter(torch.empty(n_items, d, device=dev))
        self.user_bias = nn.Parameter(torch.zeros(n_users, device=dev))
        self.item_bias = nn.Parameter(torch.zeros(n_items, device=dev))

    @torch.no_grad()
    def init_weights(self, generator):
        """U(-0.01, 0.01) tables drawn from a CPU ``torch.Generator`` in the
        JAX order (users, items 1, items 2), zero biases."""
        for p in (self.user_emb, self.item_emb1, self.item_emb2):
            p.copy_(torch.empty(p.shape).uniform_(-0.01, 0.01, generator=generator))
        self.user_bias.zero_()
        self.item_bias.zero_()
        return self

    def _item_tables(self):
        return (self.item_emb1, self.item_emb1) if self.tie_items else (self.item_emb1, self.item_emb2)

    def loss(self, batch, generator=None):
        u, i1, i2 = batch["users"], batch["item1"], batch["item2"]
        nu, ni1, ni2 = batch["neg_users"], batch["neg_item1"], batch["neg_item2"]
        it1, it2 = self._item_tables()
        e_u, e_1, e_2 = self.user_emb[u], it1[i1], it2[i2]
        l_u = skipgram(e_u, e_1 + e_2, self.user_bias[u], self.user_emb[nu], self.user_bias[nu])
        l_1 = skipgram(e_1, e_u + e_2, self.item_bias[i1], it1[ni1], self.item_bias[ni1])
        l_2 = skipgram(e_2, e_u + e_1, self.item_bias[i2], it2[ni2], self.item_bias[ni2])
        return (l_u + l_1 + l_2) / (3 * u.shape[0])

    def user_item_embeddings(self):
        it1, it2 = self._item_tables()
        return self.user_emb, (it1 + it2) / 2
