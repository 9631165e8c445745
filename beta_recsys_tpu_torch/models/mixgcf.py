"""MixGCF: hard negatives synthesized by positive and hop mixing on a
LightGCN-style backbone.

Counterpart of ``beta_recsys_tpu/models/mixgcf.py``. The backbone keeps
every hop's table (``context_hops`` propagations over the ``sym``
adjacency, ``artifacts["adj"]``); in training each hop drops edges
(``edge_dropout_rate``, redrawn every hop) and then messages (inverted
dropout at ``mess_dropout_rate``), drawn from the generator the loss is
given. For each of ``K`` negatives, ``n_negs`` candidates are mixed with
the positive hop by hop (a uniform seed per (row, hop), ``mixing_seeds``)
and, at each hop, the candidate the user's pooled query scores highest is
kept (an argmax outside autograd); ``ns`` "rns" takes the first ``K``
sampled negatives as they are. The loss is mean(log(1 + sum_k exp(neg_k -
pos))) plus ``l2`` times half the squared hop-0 rows over the batch. The
pools: mean, sum, concat and final. Parameter names follow the JAX params
tree (``user_emb``, ``item_emb``, Xavier uniform).
"""

import torch
from torch import nn

from ..core.mixed_precision import promoted
from ..ops.attention import inverted_dropout
from ..ops.graph import edge_dropout
from .base import RecModel
from .lightgcn import graph_propagator, xavier_uniform_


def mixing_seeds(generator, shape, device):
    """Positive mixing's U[0, 1) seeds, drawn on ``device``."""
    return torch.rand(shape, generator=generator, device=device)


class MixGCF(RecModel):
    batch_kind = "multineg"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.n_hops = int(config.get("context_hops", 3))
        self.pool = config.get("pool", "mean")
        self.decay = float(config.get("l2", 1e-4))
        self.n_negs = int(config.get("n_negs", 16))
        self.K = int(config.get("K", 1))
        self.ns = config.get("ns", "mixgcf")
        self.edge_dropout_rate = float(config.get("edge_dropout_rate", 0.0))
        self.mess_dropout_rate = float(config.get("mess_dropout_rate", 0.0))
        self.prop = graph_propagator(self, config)
        self.user_emb = nn.Parameter(torch.empty(n_users, self.emb_dim, device=self.device))
        self.item_emb = nn.Parameter(torch.empty(n_items, self.emb_dim, device=self.device))

    @property
    def num_neg(self):
        """Negatives a positive the epoch draws: K groups of n_negs."""
        return self.K * self.n_negs

    @torch.no_grad()
    def init_weights(self, generator):
        """Xavier-uniform tables drawn from a CPU ``torch.Generator``."""
        for p in (self.user_emb, self.item_emb):
            p.copy_(xavier_uniform_(torch.empty(p.shape), generator))
        return self

    def gcn(self, generator=None):
        """Every hop's tables: (n_users, H+1, d), (n_items, H+1, d); the
        dropouts only with a generator (training)."""
        ego = torch.cat([self.user_emb, self.item_emb])
        embs = [ego]
        for _ in range(self.n_hops):
            vals = None
            if generator is not None and self.edge_dropout_rate > 0:
                vals = edge_dropout(generator, self.prop.vals, 1 - self.edge_dropout_rate)
            ego = self.prop.spmm(ego, vals)
            ego = inverted_dropout(generator, ego, self.mess_dropout_rate)
            embs.append(ego)
        stacked = torch.stack(embs, dim=1)
        return stacked[: self.n_users], stacked[self.n_users:]

    def pooling(self, embs):
        if self.pool == "mean":
            return embs.mean(dim=1)
        if self.pool == "sum":
            return embs.sum(dim=1)
        if self.pool == "concat":
            return embs.reshape(embs.shape[0], -1)
        return embs[:, -1, :]  # "final"

    def user_item_embeddings(self):
        u, i = self.gcn()
        return self.pooling(u), self.pooling(i)

    def _mix_negatives(self, generator, user_hop, item_hop, users, neg_group, pos):
        """Positive and hop mixing of one group of n_negs candidates -> the
        synthesized negatives' hops (B, H+1, d)."""
        s_e = user_hop[users]  # (B, H+1, d)
        if self.pool != "concat":
            s_e = self.pooling(s_e)[:, None, :].expand(-1, user_hop.shape[1], -1)
        p_e = item_hop[pos]
        n_e = item_hop[neg_group]  # (B, n_negs, H+1, d)
        b, hops = n_e.shape[0], n_e.shape[2]
        seed = mixing_seeds(generator, (b, 1, hops, 1), n_e.device)
        mixed = seed * p_e[:, None, :, :] + (1 - seed) * n_e
        scores = torch.einsum("bhd,bnhd->bnh", *promoted(s_e, mixed))  # float32 seeds promote, as in JAX
        idx = scores.detach().argmax(dim=1)  # (B, H+1)
        rows = torch.arange(b, device=idx.device)[:, None]
        return mixed[rows, idx, torch.arange(hops, device=idx.device)[None, :]]

    def loss(self, batch, generator=None):
        users, pos, negs = batch["users"], batch["pos_items"], batch["neg_items"]
        user_hop, item_hop = self.gcn(generator)
        if self.ns == "rns":
            neg_embs = item_hop[negs[:, : self.K]]  # (B, K, H+1, d)
        else:
            neg_embs = torch.stack([
                self._mix_negatives(generator, user_hop, item_hop, users,
                                    negs[:, k * self.n_negs: (k + 1) * self.n_negs], pos)
                for k in range(self.K)
            ], dim=1)
        u_hop, p_hop = user_hop[users], item_hop[pos]
        u_e, pos_e = self.pooling(u_hop), self.pooling(p_hop)
        b, k = neg_embs.shape[:2]
        neg_e = self.pooling(neg_embs.reshape(b * k, *neg_embs.shape[2:])).reshape(b, k, -1)
        pos_scores = (u_e * pos_e).sum(dim=1)
        neg_scores = (u_e[:, None, :] * neg_e).sum(dim=-1)
        mf_loss = torch.log(1 + torch.exp(neg_scores - pos_scores[:, None]).sum(dim=1)).mean()
        reg = 0.5 * (u_hop[:, 0, :].square().sum() + p_hop[:, 0, :].square().sum()
                     + neg_embs[:, :, 0, :].square().sum()) / users.shape[0]
        return mf_loss + self.decay * reg
