"""LightGCN: layer-averaged linear propagation over the user-item graph.

Counterpart of ``beta_recsys_tpu/models/lightgcn.py``: Xavier-uniform
tables, ``len(layer_size)`` propagations through the normalized adjacency
(``artifacts["adj"]``, the (rows, cols, vals) of ``BaseData.get_norm_adj``),
the mean over the layer outputs; ``score_pairs`` is the sigmoid of the dot
product, ``score_candidates`` and ``score_all`` the raw dot products;
softplus-BPR plus ``decay`` (``regs[0]``) times half the squared ego rows
over the batch. In training, with ``keep_pro`` < 1, each step drops edges
once, drawn from the generator the loss is given, and every layer of that
step propagates through the same dropped values. Parameter names follow the
JAX params tree (``user_emb``, ``item_emb``).
"""

import math

import torch
from torch import nn

from ..ops.graph import edge_dropout, pack_propagator, propagate_mean
from .base import RecModel
from .losses import softplus_bpr_loss


def xavier_uniform_(tensor, generator):
    """U(-a, a), a = sqrt(6 / (fan_in + fan_out)), over a 2-D tensor, as
    ``jax.nn.initializers.xavier_uniform`` draws it, from a CPU generator."""
    limit = math.sqrt(6.0 / sum(tensor.shape))
    return tensor.uniform_(-limit, limit, generator=generator)


def decay_of(config):
    regs = config.get("regs", [1e-5])
    return float(regs[0] if isinstance(regs, (list, tuple)) else regs)


def graph_propagator(model, config):
    """The packed propagator of ``model.artifacts["adj"]`` on the model's
    device, in ``config``'s ``graph_format`` ("auto" by default)."""
    if "adj" not in model.artifacts:
        raise ValueError(f"{type(model).__name__} propagates over artifacts['adj'] (BaseData.get_norm_adj): "
                         "build it with the data (load(model_dir, data) needs data=)")
    rows, cols, vals = model.artifacts["adj"]
    return pack_propagator(rows, cols, vals, model.n_users + model.n_items, fmt=config.get("graph_format", "auto"),
                           device=model.device)


class LightGCN(RecModel):
    batch_kind = "pairwise"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.n_layers = len(config.get("layer_size", [64, 64, 64]))
        self.decay = decay_of(config)
        self.keep_prob = float(config.get("keep_pro", 1.0))
        self.prop = graph_propagator(self, config)
        d, dev = self.emb_dim, self.device
        self.user_emb = nn.Parameter(torch.empty(n_users, d, device=dev))
        self.item_emb = nn.Parameter(torch.empty(n_items, d, device=dev))

    @torch.no_grad()
    def init_weights(self, generator):
        """Xavier-uniform tables drawn from a CPU ``torch.Generator``."""
        for p in (self.user_emb, self.item_emb):
            p.copy_(xavier_uniform_(torch.empty(p.shape), generator))
        return self

    def propagate(self, generator=None):
        """(user, item) propagated tables; edge dropout only with a generator
        (training) and ``keep_pro`` < 1."""
        vals = None
        if generator is not None and self.keep_prob < 1.0:
            vals = edge_dropout(generator, self.prop.vals, self.keep_prob)
        return propagate_mean(self.prop, self.user_emb, self.item_emb, self.n_layers, vals)

    def user_item_embeddings(self):
        return self.propagate()

    def score_pairs(self, users, items):
        u_final, i_final = self._embeddings()
        return torch.sigmoid((u_final[users] * i_final[items]).sum(dim=-1))

    def loss(self, batch, generator=None):
        users, pos, neg = batch["users"], batch["pos_items"], batch["neg_items"]
        u_final, i_final = self.propagate(generator)
        u_rows = u_final[users]
        pos_scores = (u_rows * i_final[pos]).sum(dim=-1)
        neg_scores = (u_rows * i_final[neg]).sum(dim=-1)
        reg = 0.5 * (
            self.user_emb[users].square().sum() + self.item_emb[pos].square().sum()
            + self.item_emb[neg].square().sum()
        ) / users.shape[0]
        return softplus_bpr_loss(pos_scores, neg_scores) + self.decay * reg
