"""PairwiseGMF: a GMF tower with a ReLU output, trained with BPR; it
pretrains CMN's memories.

Counterpart of ``beta_recsys_tpu/models/pairwise_gmf.py``: score =
relu((u * i) @ v), truncated-normal memories (stddev 0.01, cut at +-2
stddev), a Xavier-uniform ``v``; BPR plus ``regs[0]`` times the squared
looked-up rows over the batch. Parameter names and layouts follow the JAX
params tree: ``user_memory``, ``item_memory`` and ``v`` as (d, 1), applied
as ``x @ v``.
"""

import torch
from torch import nn

from .base import RecModel
from .lightgcn import decay_of, xavier_uniform_
from .losses import bpr_loss, l2_reg


def truncated_normal_(tensor, stddev, generator):
    """``jax.nn.initializers.truncated_normal(stddev)``: stddev times a
    standard normal cut at +-2 (its std ~0.88 stddev)."""
    return nn.init.trunc_normal_(tensor, 0.0, stddev, -2 * stddev, 2 * stddev, generator=generator)


class PairwiseGMF(RecModel):
    batch_kind = "pairwise"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.stddev = float(config.get("stddev", 0.01))
        self.reg = decay_of(config)
        d, dev = self.emb_dim, self.device
        self.user_memory = nn.Parameter(torch.empty(n_users, d, device=dev))
        self.item_memory = nn.Parameter(torch.empty(n_items, d, device=dev))
        self.v = nn.Parameter(torch.empty(d, 1, device=dev))

    @torch.no_grad()
    def init_weights(self, generator):
        """Truncated-normal memories and a Xavier-uniform ``v``, drawn from a
        CPU ``torch.Generator``."""
        for p in (self.user_memory, self.item_memory):
            p.copy_(truncated_normal_(torch.empty(p.shape), self.stddev, generator))
        self.v.copy_(xavier_uniform_(torch.empty(self.v.shape), generator))
        return self

    def score_pairs(self, users, items):
        prod = self.user_memory[users] * self.item_memory[items]
        return torch.relu(prod @ self.v)[..., 0]

    def loss(self, batch, generator=None):
        users, pos, neg = batch["users"], batch["pos_items"], batch["neg_items"]
        reg = l2_reg(self.user_memory[users], self.item_memory[pos], self.item_memory[neg],
                     batch_size=users.shape[0])
        return bpr_loss(self.score_pairs(users, pos), self.score_pairs(users, neg)) + self.reg * reg
