"""SGL: LightGCN with a contrastive loss between two augmented graph views.

Counterpart of ``beta_recsys_tpu/models/sgl.py``: Xavier-uniform tables; the
main propagation is the mean of the ego table and ``n_layers`` propagations
over the ``sym`` adjacency (``artifacts["adj"]``). Each training loss draws
two views from the generator it is given (``ops/graph.sgl_augment``: node
dropout for ``aug_type`` 0, edge dropout for 1, both one subgraph for every
layer; random walk for 2, a fresh subgraph each layer) and contrasts them
by InfoNCE at ``ssl_temp`` against the whole normalized second view
(``ssl_mode`` user_side, item_side, both_side or merge, the batch's ids as
they come). The loss is the summed BPR -log(sigma(pos - neg) + 1e-10),
plus ``regs[0]`` times half the squared ego rows, plus ``ssl_reg`` times
the InfoNCE. On the dense route a view builds its A once (aug_type 0/1) or
once a layer (2). Parameter names follow the JAX params tree
(``user_emb``, ``item_emb``).
"""

import torch
from torch import nn

from ..ops.graph import sgl_augment, sgl_draws, undirected_pairs
from .base import RecModel
from .lightgcn import decay_of, graph_propagator, xavier_uniform_
from .simgcl import l2_rows

SSL_MODES = ("user_side", "item_side", "both_side", "merge")


class SGL(RecModel):
    batch_kind = "pairwise"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.n_layers = int(config.get("n_layers", 3))
        self.reg = decay_of(config)
        self.ssl_reg = float(config.get("ssl_reg", 0.1))
        self.ssl_temp = float(config.get("ssl_temp", 0.2))
        self.ssl_mode = config.get("ssl_mode", "both_side")
        if self.ssl_mode not in SSL_MODES:
            raise ValueError(f"Invalid ssl_mode {self.ssl_mode}")
        self.ssl_ratio = float(config.get("ssl_ratio", 0.1))
        self.aug_type = int(config.get("aug_type", 1))
        self.prop = graph_propagator(self, config)
        rows, cols, _ = self.artifacts["adj"]
        edge_pair, self.n_pairs = undirected_pairs(rows, cols)
        self.adj_rows, self.adj_cols, self.edge_pair = (
            torch.as_tensor(x, dtype=torch.long, device=self.device) for x in (rows, cols, edge_pair))
        self.user_emb = nn.Parameter(torch.empty(n_users, self.emb_dim, device=self.device))
        self.item_emb = nn.Parameter(torch.empty(n_items, self.emb_dim, device=self.device))

    @torch.no_grad()
    def init_weights(self, generator):
        """Xavier-uniform tables drawn from a CPU ``torch.Generator``."""
        for p in (self.user_emb, self.item_emb):
            p.copy_(xavier_uniform_(torch.empty(p.shape), generator))
        return self

    def _propagate(self, layer_ops):
        """The layer mean over the ego table and one propagation through each
        of ``layer_ops`` (x -> A @ x), split into (users, items)."""
        ego = torch.cat([self.user_emb, self.item_emb])
        acc = ego
        for spmm in layer_ops:
            ego = spmm(ego)
            acc = acc + ego
        final = acc / (len(layer_ops) + 1)
        return final[: self.n_users], final[self.n_users:]

    def propagate(self):
        return self._propagate([self.prop.operator()] * self.n_layers)

    def augment(self, generator):
        """One augmented subgraph's edge values (COO order)."""
        n_nodes = self.n_users + self.n_items
        draws = sgl_draws(generator, n_nodes if self.aug_type == 0 else self.n_pairs, self.device)
        return sgl_augment(draws, self.adj_rows, self.adj_cols, self.edge_pair, n_nodes, self.aug_type,
                           self.ssl_ratio)

    def augmented_view(self, generator):
        if self.aug_type == 2:  # random walk: a fresh subgraph each layer
            layer_ops = [self.prop.operator(self.augment(generator)) for _ in range(self.n_layers)]
        else:
            layer_ops = [self.prop.operator(self.augment(generator))] * self.n_layers
        return self._propagate(layer_ops)

    def user_item_embeddings(self):
        return self.propagate()

    def _info_nce(self, anchor, positive, all_candidates):
        a, p, c = l2_rows(anchor), l2_rows(positive), l2_rows(all_candidates)
        pos = torch.exp((a * p).sum(dim=1) / self.ssl_temp)
        ttl = torch.exp(a @ c.T / self.ssl_temp).sum(dim=1)
        return -torch.log(pos / ttl).sum()

    def loss(self, batch, generator=None):
        users, pos, neg = batch["users"], batch["pos_items"], batch["neg_items"]
        u_final, i_final = self.propagate()
        u_e = u_final[users]
        pos_scores = (u_e * i_final[pos]).sum(dim=1)
        neg_scores = (u_e * i_final[neg]).sum(dim=1)
        bpr = -torch.log(torch.sigmoid(pos_scores - neg_scores) + 1e-10).sum()
        reg = 0.5 * (self.user_emb[users].square().sum() + self.item_emb[pos].square().sum()
                     + self.item_emb[neg].square().sum())
        u1, i1 = self.augmented_view(generator)
        u2, i2 = self.augmented_view(generator)
        if self.ssl_mode == "user_side":
            ssl = self._info_nce(u1[users], u2[users], u2)
        elif self.ssl_mode == "item_side":
            ssl = self._info_nce(i1[pos], i2[pos], i2)
        elif self.ssl_mode == "both_side":
            ssl = self._info_nce(u1[users], u2[users], u2) + self._info_nce(i1[pos], i2[pos], i2)
        else:  # merge
            m2 = torch.cat([u2[users], i2[pos]])
            ssl = self._info_nce(torch.cat([u1[users], i1[pos]]), m2, m2)
        return bpr + self.reg * reg + self.ssl_reg * ssl
