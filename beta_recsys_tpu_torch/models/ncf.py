"""NeuMF (NCF): GMF and MLP towers fused, with the pretrain warm start.

Counterpart of ``beta_recsys_tpu/models/ncf.py``: separate GMF and MLP
tables (``user_emb_mlp``, ``item_emb_mlp``, ``user_emb_gmf``,
``item_emb_gmf``), the MLP tower of ``models/mlp.py`` halving the widths, a
final affine over concat(mlp_vector, gmf_vector), sigmoid and BCE loss.

The warm start: ``artifacts["gmf_params"]`` (a GMF params tree) replaces the
GMF tables, and ``artifacts["mlp_params"]`` (an MLP params tree) the MLP
tables and ``layers``, exactly as given, when the weights are initialised.
A tree may be the JAX package's (numpy leaves, ``layers`` a list or a dict
keyed "0", "1", ...) or the port's (``nest_dotted`` of a ``state_dict``).
"""

import torch
from torch import nn

from ..convert import flatten_params
from .base import RecModel
from .losses import bce_loss
from .mlp import dense, init_dense, n_layers_of, run_tower, tower_layers


class NeuMF(RecModel):
    batch_kind = "pointwise"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.n_layers = n_layers_of(config)
        self.dropout = float(config.get("dropout", 0.0))
        self.stddev = float(config.get("stddev", 0.01))
        self.latent_dim_mlp = self.emb_dim * (2 ** self.n_layers) // 2
        self.latent_dim_gmf = self.emb_dim
        dev = self.device
        for side, n in (("user", n_users), ("item", n_items)):
            setattr(self, f"{side}_emb_mlp", nn.Parameter(torch.empty(n, self.latent_dim_mlp, device=dev)))
            setattr(self, f"{side}_emb_gmf", nn.Parameter(torch.empty(n, self.latent_dim_gmf, device=dev)))
        self.layers = tower_layers(self.emb_dim, self.n_layers, dev)
        self.affine = dense(2 * self.emb_dim, 1, dev)

    @torch.no_grad()
    def init_weights(self, generator):
        """normal(0, stddev) tables and LeCun-normal weights with zero biases,
        drawn from a CPU ``torch.Generator``; then the warm start's trees
        replace what they hold (the JAX ``init_params``)."""
        for p in (self.user_emb_mlp, self.item_emb_mlp, self.user_emb_gmf, self.item_emb_gmf):
            p.copy_(torch.empty(p.shape).normal_(0.0, self.stddev, generator=generator))
        for layer in (*self.layers, self.affine):
            init_dense(layer, generator)
        own = dict(self.named_parameters())

        def take(name, tree, key, value):
            want = tuple(own[name].shape) if name in own else None
            if tuple(value.shape) != want:
                raise ValueError(f"{tree}[{key!r}] has shape {tuple(value.shape)}, NeuMF's {name} {want}: "
                                 "pretrain with NeuMF's emb_dim and n_layers")
            own[name].copy_(value)

        gmf = self.artifacts.get("gmf_params")
        if gmf is not None:
            given = flatten_params(gmf)
            for side in ("user", "item"):
                take(f"{side}_emb_gmf", "gmf_params", f"{side}_emb", given[f"{side}_emb"])
        mlp = self.artifacts.get("mlp_params")
        if mlp is not None:
            given = flatten_params(mlp)
            for side in ("user", "item"):
                take(f"{side}_emb_mlp", "mlp_params", f"{side}_emb", given[f"{side}_emb"])
            for name, value in given.items():
                if name.startswith("layers."):
                    take(name, "mlp_params", name, value)
        return self

    def score_pairs(self, users, items, generator=None):
        mlp_vec = torch.cat([self.user_emb_mlp[users], self.item_emb_mlp[items]], dim=-1)
        gmf_vec = self.user_emb_gmf[users] * self.item_emb_gmf[items]
        mlp_vec = run_tower(self.layers, mlp_vec, self.dropout, generator)
        fused = torch.cat([mlp_vec, gmf_vec], dim=-1)
        logits = fused @ self.affine["w"] + self.affine["b"]
        return torch.sigmoid(logits[..., 0])

    def loss(self, batch, generator=None):
        """BCE of the pairs' scores against their labels."""
        return bce_loss(self.score_pairs(batch["users"], batch["items"], generator), batch["labels"])
