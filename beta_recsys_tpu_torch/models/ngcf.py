"""NGCF: bilinear graph message passing with a transform a layer.

Counterpart of ``beta_recsys_tpu/models/ngcf.py``: per layer i, side =
A @ ego; ego = leaky_relu(side @ gc_w + gc_b) + leaky_relu((ego * side) @
bi_w + bi_b) (slope 0.01); in training inverted message dropout
(``mess_dropout[i]``) drawn from the generator the loss is given; each
layer's output L2-normalized by row (norm floored at 1e-12) and concatenated
after the ego table. Scores are dot products of the concatenated tables; BPR
plus ``decay`` (``regs[0]``) times half the squared looked-up rows over the
batch. The adjacency is ``artifacts["adj"]``. Parameter names and layouts
follow the JAX params tree: ``user_emb``, ``item_emb``, ``gc.<i>.{w, b}``
and ``bi.<i>.{w, b}``, weights (in, out), applied as ``x @ w``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import inverted_dropout
from .base import RecModel
from .lightgcn import decay_of, graph_propagator, xavier_uniform_
from .losses import bpr_loss
from .mlp import dense


class NGCF(RecModel):
    batch_kind = "pairwise"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        layer_size = list(config.get("layer_size", [64, 64, 64]))
        self.layer_dims = [self.emb_dim] + layer_size
        self.n_layers = len(layer_size)
        self.mess_dropout = list(config.get("mess_dropout", [0.1] * self.n_layers))
        self.decay = decay_of(config)
        self.prop = graph_propagator(self, config)
        d, dev = self.emb_dim, self.device
        self.user_emb = nn.Parameter(torch.empty(n_users, d, device=dev))
        self.item_emb = nn.Parameter(torch.empty(n_items, d, device=dev))
        widths = list(zip(self.layer_dims[:-1], self.layer_dims[1:]))
        self.gc = nn.ModuleList(dense(n_in, n_out, dev) for n_in, n_out in widths)
        self.bi = nn.ModuleList(dense(n_in, n_out, dev) for n_in, n_out in widths)

    @torch.no_grad()
    def init_weights(self, generator):
        """Xavier-uniform tables and weights, zero biases, drawn from a CPU
        ``torch.Generator``."""
        for p in (self.user_emb, self.item_emb):
            p.copy_(xavier_uniform_(torch.empty(p.shape), generator))
        for gc, bi in zip(self.gc, self.bi):
            for layer in (gc, bi):
                layer["w"].copy_(xavier_uniform_(torch.empty(layer["w"].shape), generator))
                layer["b"].zero_()
        return self

    def propagate(self, generator=None):
        """(user, item) concatenated multi-layer tables; message dropout only
        with a generator (training)."""
        spmm = self.prop.operator()
        ego = torch.cat([self.user_emb, self.item_emb])
        outs = [ego]
        for gc, bi, rate in zip(self.gc, self.bi, self.mess_dropout):
            side = spmm(ego)
            sum_emb = F.leaky_relu(side @ gc["w"] + gc["b"], 0.01)
            bi_emb = F.leaky_relu((ego * side) @ bi["w"] + bi["b"], 0.01)
            ego = inverted_dropout(generator, sum_emb + bi_emb, rate)
            outs.append(ego / ego.norm(dim=1, keepdim=True).clamp_min(1e-12))
        final = torch.cat(outs, dim=1)
        return final[: self.n_users], final[self.n_users:]

    def user_item_embeddings(self):
        return self.propagate()

    def loss(self, batch, generator=None):
        users, pos, neg = batch["users"], batch["pos_items"], batch["neg_items"]
        u_final, i_final = self.propagate(generator)
        u_e, p_e, n_e = u_final[users], i_final[pos], i_final[neg]
        mf_loss = bpr_loss((u_e * p_e).sum(dim=-1), (u_e * n_e).sum(dim=-1))
        reg = 0.5 * (u_e.square().sum() + p_e.square().sum() + n_e.square().sum()) / users.shape[0]
        return mf_loss + self.decay * reg
