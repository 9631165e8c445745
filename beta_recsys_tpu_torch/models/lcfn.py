"""LCFN: low-pass collaborative filtering with hypergraph spectral filters.

Counterpart of ``beta_recsys_tpu/models/lcfn.py``: P and Q are the users'
and items' smallest hypergraph-Laplacian eigenvectors
(``artifacts["graph_embeddings"]``, ``BaseData.get_graph_embeddings``).
Each of ``layer`` layers maps a table e to sigmoid(P (f * (P^T e)) T), f
the side's filter and T the layer's transformer, one T for both sides;
scores are dot products of the concatenated layer outputs (ego table
first). The loss is BPR (``losses.bpr_loss``) plus ``lamda`` times the
unsquared norms of the looked-up ego rows, every filter and every
transformer. Filters and transformers are trainable, as in the JAX package.
Tables start at 0.01 + 0.02 N(0, 1), filters at 1 + 0.001 N(0, 1),
transformers at 0.001 N(0, 1) + diag(1 + 0.001 N(0, 1)). Parameter names
follow the JAX params tree: ``user_emb``, ``item_emb``, ``user_filters.<k>``,
``item_filters.<k>``, ``transformers.<k>``.
"""

import numpy as np
import torch
from torch import nn

from ..core.mixed_precision import promoted
from .base import RecModel
from .losses import bpr_loss


class LCFN(RecModel):
    batch_kind = "pairwise"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.layer = int(config.get("layer", 1))
        self.lamda = float(config.get("lamda", 0.001))
        if "graph_embeddings" not in self.artifacts:
            raise ValueError("LCFN filters over artifacts['graph_embeddings'] (BaseData.get_graph_embeddings): "
                             "build it with the data (load(model_dir, data) needs data=)")
        P, Q = self.artifacts["graph_embeddings"]
        d, dev = self.emb_dim, self.device
        self.P, self.Q = (torch.as_tensor(np.asarray(x, np.float32), device=dev) for x in (P, Q))
        self.user_emb = nn.Parameter(torch.empty(n_users, d, device=dev))
        self.item_emb = nn.Parameter(torch.empty(n_items, d, device=dev))
        self.user_filters = nn.ParameterList(
            nn.Parameter(torch.empty(self.P.shape[1], device=dev)) for _ in range(self.layer))
        self.item_filters = nn.ParameterList(
            nn.Parameter(torch.empty(self.Q.shape[1], device=dev)) for _ in range(self.layer))
        self.transformers = nn.ParameterList(nn.Parameter(torch.empty(d, d, device=dev)) for _ in range(self.layer))

    @torch.no_grad()
    def init_weights(self, generator):
        """The JAX initializers' distributions, drawn from a CPU
        ``torch.Generator``."""
        def normal(shape):
            return torch.empty(shape).normal_(0.0, 1.0, generator=generator)

        for p in (self.user_emb, self.item_emb):
            p.copy_(0.01 + 0.02 * normal(p.shape))
        for uf, itf, t in zip(self.user_filters, self.item_filters, self.transformers):
            uf.copy_(1.0 + 0.001 * normal(uf.shape))
            itf.copy_(1.0 + 0.001 * normal(itf.shape))
            t.copy_(0.001 * normal(t.shape) + torch.diag(1.0 + 0.001 * normal(t.shape[:1])))
        return self

    def _side(self, emb, basis, filters):
        outs = [emb]
        for f, t in zip(filters, self.transformers):
            # The float32 bases promote a compute_dtype's products, as in JAX.
            filtered = basis @ (f[:, None] * torch.matmul(*promoted(basis.T, emb)))
            emb = torch.sigmoid(torch.matmul(*promoted(filtered, t)))
            outs.append(emb)
        return torch.cat(outs, dim=1)

    def propagate(self):
        return (self._side(self.user_emb, self.P, self.user_filters),
                self._side(self.item_emb, self.Q, self.item_filters))

    def user_item_embeddings(self):
        return self.propagate()

    def loss(self, batch, generator=None):
        users, pos, neg = batch["users"], batch["pos_items"], batch["neg_items"]
        u_all, i_all = self.propagate()
        u_rows = u_all[users]
        pos_scores = (u_rows * i_all[pos]).sum(dim=1)
        neg_scores = (u_rows * i_all[neg]).sum(dim=1)
        reg = self.user_emb[users].norm() + self.item_emb[pos].norm() + self.item_emb[neg].norm()
        for uf, itf, t in zip(self.user_filters, self.item_filters, self.transformers):
            reg = reg + (uf.norm() + itf.norm() + t.norm())
        return bpr_loss(pos_scores, neg_scores) + self.lamda * reg
