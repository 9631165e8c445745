"""MLP recommender: a concatenated-embedding tower with halving hidden layers.

Counterpart of ``beta_recsys_tpu/models/mlp.py``: each side's latent dim is
emb_dim * 2^n_layers / 2; the concatenated (u, i) vector passes through
``n_layers`` Linear + ReLU blocks halving the width down to emb_dim, then an
affine + sigmoid; BCE loss. In training, inverted dropout comes before each
Linear, drawn from the ``torch.Generator`` the loss is given (none, no
dropout). Parameter names and layouts follow the JAX params tree:
``user_emb``, ``item_emb``, ``layers.<i>.{w, b}`` and ``affine.{w, b}``,
with weights as (in, out), applied as ``x @ w`` (``convert.py``).
"""

import math

import torch
from torch import nn

from ..ops import activations
from ..ops.attention import inverted_dropout
from .base import RecModel
from .losses import bce_loss


def _fan_in_truncated_normal_(tensor, scale, generator):
    """``jax.nn.initializers.variance_scaling(scale, "fan_in",
    "truncated_normal")`` over an (in, out) weight: a normal truncated at +-2
    std, scaled so the variance is scale / fan_in."""
    std = math.sqrt(scale / tensor.shape[-2]) / 0.87962566103423978
    return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std, generator=generator)


def lecun_normal_(tensor, generator):
    """LeCun normal, as ``jax.nn.initializers.lecun_normal`` draws it:
    variance 1 / fan_in."""
    return _fan_in_truncated_normal_(tensor, 1.0, generator)


def he_normal_(tensor, generator):
    """He normal, as ``jax.nn.initializers.he_normal`` draws it: variance 2 /
    fan_in (``nn.init.kaiming_normal_`` is not truncated)."""
    return _fan_in_truncated_normal_(tensor, 2.0, generator)


def dense(n_in, n_out, device):
    """An (in, out) weight and its bias: the counterpart of ``_dense_init``'s
    tree, drawn by ``init_dense``."""
    return nn.ParameterDict({
        "w": nn.Parameter(torch.empty(n_in, n_out, device=device)),
        "b": nn.Parameter(torch.empty(n_out, device=device)),
    })


@torch.no_grad()
def init_dense(layer, generator):
    """LeCun-normal weight drawn on the host, zero bias."""
    layer["w"].copy_(lecun_normal_(torch.empty(layer["w"].shape), generator))
    layer["b"].zero_()


def tower_layers(emb_dim, n_layers, device):
    """The hidden blocks: widths emb_dim * 2^(n_layers - i) -> half."""
    widths = [emb_dim * 2 ** (n_layers - i) for i in range(n_layers)]
    return nn.ModuleList(dense(n_in, n_in // 2, device) for n_in in widths)


def run_tower(layers, vector, dropout, generator):
    """[dropout] -> Linear -> ReLU for each block."""
    for layer in layers:
        vector = inverted_dropout(generator, vector, dropout)
        vector = activations.relu(vector @ layer["w"] + layer["b"])
    return vector


def n_layers_of(config):
    mlp_cfg = config.get("mlp_config", {"n_layers": 3}) or {"n_layers": 3}
    return int(mlp_cfg.get("n_layers", 3))


class MLP(RecModel):
    batch_kind = "pointwise"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.n_layers = n_layers_of(config)
        self.dropout = float(config.get("dropout", 0.0))
        self.stddev = float(config.get("stddev", 0.01))
        self.latent_dim = self.emb_dim * (2 ** self.n_layers) // 2
        dev = self.device
        self.user_emb = nn.Parameter(torch.empty(n_users, self.latent_dim, device=dev))
        self.item_emb = nn.Parameter(torch.empty(n_items, self.latent_dim, device=dev))
        self.layers = tower_layers(self.emb_dim, self.n_layers, dev)
        self.affine = dense(self.emb_dim, 1, dev)

    @torch.no_grad()
    def init_weights(self, generator):
        """normal(0, stddev) tables and LeCun-normal weights with zero biases,
        drawn from a CPU ``torch.Generator`` (the JAX ``init_params``)."""
        for p in (self.user_emb, self.item_emb):
            p.copy_(torch.empty(p.shape).normal_(0.0, self.stddev, generator=generator))
        for layer in (*self.layers, self.affine):
            init_dense(layer, generator)
        return self

    def score_pairs(self, users, items, generator=None):
        vector = torch.cat([self.user_emb[users], self.item_emb[items]], dim=-1)
        vector = run_tower(self.layers, vector, self.dropout, generator)
        logits = vector @ self.affine["w"] + self.affine["b"]
        return torch.sigmoid(logits[..., 0])

    def loss(self, batch, generator=None):
        """BCE of the pairs' scores against their labels."""
        return bce_loss(self.score_pairs(batch["users"], batch["items"], generator), batch["labels"])
