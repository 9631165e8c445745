"""VBCAR: a variational Bayes context-aware basket recommender.

Counterpart of ``beta_recsys_tpu/models/vbcar.py``: a two-layer encoder
for each side over its auxiliary features (``artifacts["user_fea"]``,
``artifacts["item_fea"]``: ``GroceryData.user_item_features``) maps to the
mean and log-variance of an ``emb_dim`` latent, with ``activator`` (tanh,
sigmoid, relu, lrelu; any other name: none) between its layers. A row's
embedding is a reparameterised latent sample beside its free table row. The
loss is (1 - alpha) * GEN + alpha * KLD: GEN the skip-gram of Triple2vec
without biases over the triple and its negatives, KLD the six encoded
distributions' KL to N(0, I) (each summed over the latent, then the
negatives, then averaged over the batch) over 3. Scoring uses the posterior
means beside the free tables.

Parameter names and layouts follow the JAX params tree: ``user_emb``,
``item_emb`` (U(-r, r), r = 0.1 / sqrt(emb_dim)) and the encoders
``fc_u_1``, ``fc_u_2``, ``fc_i_1``, ``fc_i_2`` as ``{w, b}``, weights (in,
out), LeCun-normal with zero biases. The six samples draw their noise from
the generator the loss is given (``latent_noise``), in the JAX order.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..core.mixed_precision import promoted
from .base import RecModel
from .mlp import dense, init_dense
from .triple2vec import skipgram

ACTIVATIONS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, "relu": torch.relu, "lrelu": F.leaky_relu}


def latent_noise(generator, shape, device):
    """A reparameterised sample's standard-normal draw."""
    return torch.randn(shape, generator=generator, device=device)


def kl_std_normal(dist):
    """KL(N(mu, exp(logvar)) || N(0, I)) summed over the latent (and the
    negatives), averaged over the batch."""
    mu, logvar = dist
    var = torch.exp(logvar) + 1e-10
    kl = (0.5 * (-torch.log(var) - 1 + var + mu**2)).sum(dim=-1)
    if kl.dim() > 1:
        kl = kl.sum(dim=-1)
    return kl.mean()


class VBCAR(RecModel):
    batch_kind = "triple"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.late_dim = int(config.get("late_dim", 128))
        self.n_neg = int(config.get("n_neg", 5))
        self.alpha = float(config.get("alpha", 0.05))
        self.act = ACTIVATIONS.get(config.get("activator", "tanh"), lambda x: x)
        d, dev = self.emb_dim, self.device
        self.user_fea = torch.as_tensor(self.artifacts["user_fea"], dtype=torch.float32, device=dev)
        self.item_fea = torch.as_tensor(self.artifacts["item_fea"], dtype=torch.float32, device=dev)
        self.user_emb = nn.Parameter(torch.empty(n_users, d, device=dev))
        self.item_emb = nn.Parameter(torch.empty(n_items, d, device=dev))
        self.fc_u_1 = dense(self.user_fea.shape[1], self.late_dim, dev)
        self.fc_u_2 = dense(self.late_dim, 2 * d, dev)
        self.fc_i_1 = dense(self.item_fea.shape[1], self.late_dim, dev)
        self.fc_i_2 = dense(self.late_dim, 2 * d, dev)

    @torch.no_grad()
    def init_weights(self, generator):
        """The tables U(-r, r), then the four encoder layers LeCun-normal
        with zero biases, drawn from a CPU ``torch.Generator`` in the JAX
        order."""
        r = 0.1 * self.emb_dim ** -0.5
        for p in (self.user_emb, self.item_emb):
            p.copy_(torch.empty(p.shape).uniform_(-r, r, generator=generator))
        for layer in (self.fc_u_1, self.fc_u_2, self.fc_i_1, self.fc_i_2):
            init_dense(layer, generator)
        return self

    def _encode(self, fea, idx, l1, l2):
        # Float32 features promote a compute_dtype's products, as in JAX.
        h = self.act(torch.matmul(*promoted(fea[idx], l1["w"])) + l1["b"])
        h = torch.matmul(*promoted(h, l2["w"])) + l2["b"]
        return h[..., : self.emb_dim], h[..., self.emb_dim:]  # mu, logvar

    def user_encode(self, idx):
        return self._encode(self.user_fea, idx, self.fc_u_1, self.fc_u_2)

    def item_encode(self, idx):
        return self._encode(self.item_fea, idx, self.fc_i_1, self.fc_i_2)

    @staticmethod
    def _sample(dist, generator):
        mu, logvar = dist
        return mu + torch.exp(0.5 * logvar) * latent_noise(generator, mu.shape, mu.device)

    def _posteriors(self, batch):
        """The six (mu, logvar) of the batch (users, items 1, items 2 and
        their negatives) and their KL term."""
        dists = (self.user_encode(batch["users"]), self.item_encode(batch["item1"]),
                 self.item_encode(batch["item2"]), self.user_encode(batch["neg_users"]),
                 self.item_encode(batch["neg_item1"]), self.item_encode(batch["neg_item2"]))
        return dists, sum(kl_std_normal(dist) for dist in dists) / 3

    def loss(self, batch, generator=None):
        """(1 - alpha) * GEN + alpha * KLD. The latent noise needs the
        ``generator``."""
        if generator is None:
            raise ValueError(f"{type(self).__name__}'s loss draws its latent noise from a generator: pass one")
        dists, kld = self._posteriors(batch)
        rows = (self.user_emb, self.item_emb, self.item_emb) * 2
        ids = ("users", "item1", "item2", "neg_users", "neg_item1", "neg_item2")
        e_u, e_1, e_2, e_nu, e_n1, e_n2 = (torch.cat([self._sample(dist, generator), table[batch[key]]], dim=-1)
                                           for dist, table, key in zip(dists, rows, ids))
        gen = (skipgram(e_u, e_1 + e_2, 0.0, e_nu, 0.0) + skipgram(e_1, e_u + e_2, 0.0, e_n1, 0.0)
               + skipgram(e_2, e_u + e_1, 0.0, e_n2, 0.0)) / (3 * e_u.shape[0])
        return (1 - self.alpha) * gen + self.alpha * kld

    def _user_item_means(self):
        users = torch.arange(self.n_users, device=self.device)
        items = torch.arange(self.n_items, device=self.device)
        return self.user_encode(users)[0], self.item_encode(items)[0]

    def user_item_embeddings(self):
        u_mu, i_mu = self._user_item_means()
        return torch.cat([u_mu, self.user_emb], dim=-1), torch.cat([i_mu, self.item_emb], dim=-1)
