"""UltraGCN: constraint-weighted BCE on multineg batches, with no
propagation.

Counterpart of ``beta_recsys_tpu/models/ultragcn.py``: a positive's
softplus(-u.i) weighs w1 + w2 * beta_u * beta_i, each negative's
softplus(u.j) w3 + w4 * beta_u * beta_j, the negatives averaged and scaled
by ``negative_weight``; ``lambda`` times the item-item term -sim *
log_sigmoid(u . e_n) over the positive's top-K neighbours
(``artifacts["ii_neighbors"]``, ``["ii_sims"]``, from
``ops/ultragcn_prep.get_ii_constraint_mat``); ``gamma`` times half the
squared whole tables, each step. The degree vectors (beta_u, beta_i) are
``artifacts["constraint"]`` (``BaseData.create_constraint_mat``). Tables
start at ``stddev`` (1e-3) times a standard normal; scores are their dot
products. Parameter names follow the JAX params tree (``user_emb``,
``item_emb``).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .base import RecModel


class UltraGCN(RecModel):
    batch_kind = "multineg"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.w1, self.w2 = float(config.get("w1", 1e-7)), float(config.get("w2", 1.0))
        self.w3, self.w4 = float(config.get("w3", 1e-7)), float(config.get("w4", 1.0))
        self.negative_weight = float(config.get("negative_weight", 1.0))
        self.gamma = float(config.get("gamma", 1e-4))
        self.lambda_ = float(config.get("lambda", 1.0))
        self.stddev = float(config.get("stddev", 1e-3))
        if "constraint" not in self.artifacts:
            raise ValueError("UltraGCN needs artifacts['constraint'], ['ii_neighbors'] and ['ii_sims']: build them "
                             "with the data (load(model_dir, data) needs data=)")
        dev = self.device

        def on_device(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        beta_ud, beta_id = self.artifacts["constraint"]
        self.beta_ud, self.beta_id = on_device(beta_ud, torch.float32), on_device(beta_id, torch.float32)
        self.ii_neighbors = on_device(self.artifacts["ii_neighbors"], torch.long)
        self.ii_sims = on_device(self.artifacts["ii_sims"], torch.float32)
        self.user_emb = nn.Parameter(torch.empty(n_users, self.emb_dim, device=dev))
        self.item_emb = nn.Parameter(torch.empty(n_items, self.emb_dim, device=dev))

    @torch.no_grad()
    def init_weights(self, generator):
        """stddev * N(0, 1) tables drawn from a CPU ``torch.Generator``."""
        for p in (self.user_emb, self.item_emb):
            p.copy_(torch.empty(p.shape).normal_(0.0, 1.0, generator=generator) * self.stddev)
        return self

    def user_item_embeddings(self):
        return self.user_emb, self.item_emb

    def loss(self, batch, generator=None):
        users, pos, negs = batch["users"], batch["pos_items"], batch["neg_items"]
        u_e, p_e, n_e = self.user_emb[users], self.item_emb[pos], self.item_emb[negs]  # n_e (B, N, d)
        pos_w = (self.w1 + self.w2 * self.beta_ud[users] * self.beta_id[pos] if self.w2 > 0
                 else torch.full(users.shape, self.w1, device=users.device))
        neg_w = (self.w3 + self.w4 * self.beta_ud[users][:, None] * self.beta_id[negs] if self.w4 > 0
                 else torch.full(negs.shape, self.w3, device=negs.device))
        pos_scores = (u_e * p_e).sum(dim=-1)
        neg_scores = (u_e[:, None, :] * n_e).sum(dim=-1)
        pos_loss = pos_w * F.softplus(-pos_scores)
        neg_loss = (neg_w * F.softplus(neg_scores)).mean(dim=-1)
        loss_l = (pos_loss + neg_loss * self.negative_weight).sum()
        nb_e = self.item_emb[self.ii_neighbors[pos]]  # (B, K, d)
        loss_i = -(self.ii_sims[pos] * F.logsigmoid((u_e[:, None, :] * nb_e).sum(dim=-1))).sum()
        norm_loss = 0.5 * (self.user_emb.square().sum() + self.item_emb.square().sum())
        return loss_l + self.gamma * norm_loss + self.lambda_ * loss_i
