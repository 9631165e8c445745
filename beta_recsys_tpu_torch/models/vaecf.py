"""VAE-CF: a variational autoencoder over binarized user rows.

Counterpart of ``beta_recsys_tpu/models/vaecf.py``: an encoder MLP
([n_items] + ae_structure, with the configured activation) to the mean and
log-variance of a ``z_dim`` latent, a mirrored decoder (no activation after
its last layer; a softmax for the "mult" likelihood, else a sigmoid), and
the loss mean(beta * KL - ll) at z = mu + exp(logvar / 2) * eps, eps drawn
from the generator the loss is given (``latent_noise``). Scoring decodes
the mean of each user's row (``artifacts["user_rows"]``).

Parameter names and layouts follow the JAX params tree: ``enc.<i>.{w, b}``,
``dec.<i>.{w, b}``, ``mu.{w, b}`` and ``logvar.{w, b}``, weights (in, out),
LeCun-normal with zero biases at initialisation.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..core.mixed_precision import promoted
from .base import RecModel
from .mlp import dense, init_dense

EPS = 1e-10

ACTIVATIONS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu, "relu6": F.relu6}


def latent_noise(generator, shape, device):
    """The reparameterisation's standard-normal draw."""
    return torch.randn(shape, generator=generator, device=device)


class VAECF(RecModel):
    batch_kind = "userrow"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.z_dim = int(config.get("z_dim", 10))
        self.structure = [n_items] + [int(w) for w in config.get("ae_structure", [20])]
        self.act = ACTIVATIONS[config.get("activation", "tanh")]
        self.likelihood = config.get("likelihood", "mult")
        if self.likelihood not in ("mult", "bern", "gaus", "pois"):
            raise ValueError(f"Unknown likelihood {self.likelihood}")
        self.beta = float(config.get("beta", 1.0))
        dev, widths = self.device, self.structure
        dec_widths = [self.z_dim] + widths[::-1]
        self.enc = nn.ModuleList(dense(widths[i], widths[i + 1], dev) for i in range(len(widths) - 1))
        self.dec = nn.ModuleList(dense(dec_widths[i], dec_widths[i + 1], dev) for i in range(len(dec_widths) - 1))
        self.mu = dense(widths[-1], self.z_dim, dev)
        self.logvar = dense(widths[-1], self.z_dim, dev)
        rows = self.artifacts.get("user_rows")
        self.user_rows = None if rows is None else torch.as_tensor(rows, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def init_weights(self, generator):
        """LeCun-normal weights and zero biases, drawn from a CPU
        ``torch.Generator`` in the JAX order: encoder, decoder, mu, logvar."""
        for layer in (*self.enc, *self.dec, self.mu, self.logvar):
            init_dense(layer, generator)
        return self

    def encode(self, x):
        h = x
        for layer in self.enc:  # float32 rows promote a compute_dtype's products, as in JAX
            h = self.act(torch.matmul(*promoted(h, layer["w"])) + layer["b"])
        return (torch.matmul(*promoted(h, self.mu["w"])) + self.mu["b"],
                torch.matmul(*promoted(h, self.logvar["w"])) + self.logvar["b"])

    def decode(self, z):
        h = z
        for i, layer in enumerate(self.dec):
            h = torch.matmul(*promoted(h, layer["w"])) + layer["b"]
            if i != len(self.dec) - 1:
                h = self.act(h)
        return torch.softmax(h, dim=-1) if self.likelihood == "mult" else torch.sigmoid(h)

    def loss(self, batch, generator=None):
        """mean(beta * KL(q(z | x) || N(0, I)) - log-likelihood of the row).
        The latent noise needs the ``generator``."""
        if generator is None:
            raise ValueError("VAECF's loss draws its latent noise from a generator: pass one")
        x = batch["rows"]
        mu, logvar = self.encode(x)
        z = mu + torch.exp(0.5 * logvar) * latent_noise(generator, mu.shape, mu.device)
        x_ = self.decode(z)
        if self.likelihood == "mult":
            ll = x * torch.log(x_ + EPS)
        elif self.likelihood == "bern":
            ll = x * torch.log(x_ + EPS) + (1 - x) * torch.log1p(-x_ + EPS)
        elif self.likelihood == "gaus":
            ll = -((x - x_) ** 2)
        else:
            ll = x * torch.log(x_ + EPS) - x_
        kld = -0.5 * (1 + logvar - mu**2 - torch.exp(logvar)).sum(dim=1)
        return (self.beta * kld - ll.sum(dim=1)).mean()

    def _reconstruct(self, users):
        if self.user_rows is None:
            raise ValueError("VAECF needs artifacts['user_rows'] to score")
        return self.decode(self.encode(self.user_rows[users])[0])

    def score_candidates(self, users, cand_items):
        return self._reconstruct(users).gather(1, cand_items)

    def score_all(self, users):
        return self._reconstruct(users)

    def score_pairs(self, users, items):
        """Each pair's reconstructed probability, as ``score_candidates``
        gives it for one candidate (the JAX model has no pair score); each
        user's row is decoded once."""
        uniq, inv = torch.unique(users, return_inverse=True)
        return self._reconstruct(uniq)[inv, items]
