"""SimGCL: LightGCN propagation with a noise-perturbed contrastive loss.

Counterpart of ``beta_recsys_tpu/models/simgcl.py``: Xavier-uniform tables;
propagation is the mean of ``n_layer`` propagations over the ``sym``
adjacency (``artifacts["adj"]``) with no ego layer; a perturbed layer adds
sign(e) * normalize(U[0, 1)) * ``eps``, its noise drawn from the generator
the loss is given (``perturbation_noise``). Serving scores the raw tables.
The loss is the summed BPR -log(1e-7 + sigma(pos - neg)), plus ``reg``
times the unsquared norms of the looked-up rows, plus ``lambda`` times an
InfoNCE at ``temperature`` between two perturbed views, over the batch's
users and positives as they come (no dedup). Parameter names follow the
JAX params tree (``user_emb``, ``item_emb``).
"""

import torch
from torch import nn

from .base import RecModel
from .lightgcn import graph_propagator, xavier_uniform_


def perturbation_noise(generator, shape, device):
    """A perturbed layer's U[0, 1) noise, drawn on ``device``."""
    return torch.rand(shape, generator=generator, device=device)


def l2_rows(v):
    """Each row over its L2 norm, floored at 1e-12."""
    return v / v.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class SimGCL(RecModel):
    batch_kind = "pairwise"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.eps = float(config.get("eps", 0.1))
        self.n_layers = int(config.get("n_layer", 3))
        self.reg = float(config.get("reg", 1e-4))
        self.cl_rate = float(config.get("lambda", 0.5))
        self.temp = float(config.get("temperature", 0.2))
        self.prop = graph_propagator(self, config)
        self.user_emb = nn.Parameter(torch.empty(n_users, self.emb_dim, device=self.device))
        self.item_emb = nn.Parameter(torch.empty(n_items, self.emb_dim, device=self.device))

    @torch.no_grad()
    def init_weights(self, generator):
        """Xavier-uniform tables drawn from a CPU ``torch.Generator``."""
        for p in (self.user_emb, self.item_emb):
            p.copy_(xavier_uniform_(torch.empty(p.shape), generator))
        return self

    def propagate(self, generator=None):
        """The mean of ``n_layers`` propagated tables, (users, items);
        perturbed when a generator is given."""
        spmm = self.prop.operator()
        ego = torch.cat([self.user_emb, self.item_emb])
        acc = torch.zeros_like(ego)
        for _ in range(self.n_layers):
            ego = spmm(ego)
            if generator is not None:
                noise = l2_rows(perturbation_noise(generator, ego.shape, ego.device))
                ego = ego + torch.sign(ego) * noise * self.eps
            acc = acc + ego
        final = acc / self.n_layers
        return final[: self.n_users], final[self.n_users:]

    def user_item_embeddings(self):
        return self.user_emb, self.item_emb

    def _info_nce(self, v1, v2):
        pos = torch.exp((v1 * v2).sum(dim=-1) / self.temp)
        ttl = torch.exp(v1 @ v2.T / self.temp).sum(dim=1)
        return -torch.log(pos / ttl).sum()

    def loss(self, batch, generator=None):
        """Without a generator the contrastive views are unperturbed."""
        users, pos, neg = batch["users"], batch["pos_items"], batch["neg_items"]
        u_final, i_final = self.propagate()
        u_e, p_e, n_e = u_final[users], i_final[pos], i_final[neg]
        pos_scores = (u_e * p_e).sum(dim=-1)
        neg_scores = (u_e * n_e).sum(dim=-1)
        rec_loss = -torch.log(1e-7 + torch.sigmoid(pos_scores - neg_scores)).sum()
        reg_loss = self.reg * (u_e.norm() + p_e.norm() + n_e.norm())
        u1, i1 = self.propagate(generator)
        u2, i2 = self.propagate(generator)
        cl = (self._info_nce(l2_rows(u1)[users], l2_rows(u2)[users])
              + self._info_nce(l2_rows(i1)[pos], l2_rows(i2)[pos]))
        return rec_loss + reg_loss + self.cl_rate * cl
