"""TVBR: VBCAR conditioned on a time bucket.

Counterpart of ``beta_recsys_tpu/models/tvbr.py``: each triple carries its
time bucket t (``GroceryData.sample_triples(..., time_step)``). Four heads
(``time2mean_u``, ``time2std_u``, ``time2mean_i``, ``time2std_i``: {w, b},
weights (in, out)) map [the encoder's statistic, one_hot(t), the row's
features] to the time-t mean and log-variance; the prior is the same heads
at max(t - 1, 0), and the KL term is KL(posterior || prior) between
diagonal Gaussians. Scoring conditions on t = ``time_step``, a valid
one-hot index since ``time_dim`` is ``time_step + 1``, although training
draws buckets below it.
"""

import torch
import torch.nn.functional as F

from ..core.mixed_precision import promoted
from .mlp import dense, init_dense
from .vbcar import VBCAR


def kl_pair(post, prior):
    """KL(post || prior) between diagonal Gaussians, summed over the latent
    (and the negatives), averaged over the batch."""
    (mu1, logvar1), (mu2, logvar2) = post, prior
    var1 = torch.exp(logvar1) + 1e-10
    var2 = torch.exp(logvar2) + 1e-10
    kl = (0.5 * (torch.log(var2 / var1) - 1 + var1 / var2 + (mu2 - mu1) ** 2 / var2)).sum(dim=-1)
    if kl.dim() > 1:
        kl = kl.sum(dim=-1)
    return kl.mean()


class TVBR(VBCAR):
    batch_kind = "triple"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.time_step = int(config.get("time_step", 4))
        self.time_dim = self.time_step + 1
        d, dev = self.emb_dim, self.device
        fu, fi = self.user_fea.shape[1], self.item_fea.shape[1]
        self.time2mean_u = dense(d + self.time_dim + fu, d, dev)
        self.time2std_u = dense(d + self.time_dim + fu, d, dev)
        self.time2mean_i = dense(d + self.time_dim + fi, d, dev)
        self.time2std_i = dense(d + self.time_dim + fi, d, dev)

    @torch.no_grad()
    def init_weights(self, generator):
        """VBCAR's draws, then the four heads LeCun-normal with zero biases."""
        super().init_weights(generator)
        for layer in (self.time2mean_u, self.time2std_u, self.time2mean_i, self.time2std_i):
            init_dense(layer, generator)
        return self

    def _encode_time(self, idx, t, side):
        """((mu, logvar) at bucket t, (mu, logvar) at max(t - 1, 0)) of the
        rows ``idx`` (B,) or (B, n_neg), t (B,)."""
        base_mu, base_logvar = self.user_encode(idx) if side == "u" else self.item_encode(idx)
        x_fea = (self.user_fea if side == "u" else self.item_fea)[idx]
        shape = (*base_mu.shape[:-1], self.time_dim)
        mean_head, std_head = (self.time2mean_u, self.time2std_u) if side == "u" else (self.time2mean_i,
                                                                                       self.time2std_i)

        def head(stat, bucket, p):
            one_hot = F.one_hot(bucket, self.time_dim).to(stat.dtype)
            one_hot = one_hot.view(*bucket.shape, *(1,) * (stat.dim() - 1 - bucket.dim()), -1).expand(shape)
            # Float32 features promote a compute_dtype's product, as in JAX.
            return torch.matmul(*promoted(torch.cat([stat, one_hot, x_fea], dim=-1), p["w"])) + p["b"]

        prior_t = (t - 1).clamp(min=0)
        return ((head(base_mu, t, mean_head), head(base_logvar, t, std_head)),
                (head(base_mu, prior_t, mean_head), head(base_logvar, prior_t, std_head)))

    def _posteriors(self, batch):
        t = batch["t"]
        pairs = [self._encode_time(batch[key], t, side) for key, side in (
            ("users", "u"), ("item1", "i"), ("item2", "i"), ("neg_users", "u"), ("neg_item1", "i"),
            ("neg_item2", "i"))]
        return [cur for cur, _ in pairs], sum(kl_pair(cur, pri) for cur, pri in pairs) / 3

    def _user_item_means(self):
        users = torch.arange(self.n_users, device=self.device)
        items = torch.arange(self.n_items, device=self.device)
        return (self._encode_time(users, torch.full_like(users, self.time_step), "u")[0][0],
                self._encode_time(items, torch.full_like(items, self.time_step), "i")[0][0])
