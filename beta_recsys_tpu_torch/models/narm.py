"""NARM: neural attentive session-based recommendation (GRU + attention).

Counterpart of ``beta_recsys_tpu/models/narm.py``: an item table (pad row 0),
a GRU over the left-padded prefix whose hidden state holds through pad
positions, a global representation h_T, a local one attending over the
hidden states (alpha_t = sigmoid(h_t A1 + [t valid] h_T A2) v), the session
vector c = [c_local, h_T] with input and hidden dropout, and logits
c (item_emb B)^T over all n_items + 1 rows (the pad item's included), trained
with the mean negative log-softmax at the 1-indexed target.

The GRU cell is the JAX package's, n = tanh(x Wn + r * (h Un) + bn), with
``bn`` outside the reset gate (``torch.nn.GRU`` puts its b_hn inside), and
pad positions keep h; so it is written as a loop over T with ``torch.where``
(``gru_scan``), each step a few fused device activities.

Parameter names and layouts follow the JAX params tree: ``item_emb``,
``gru.{wz,uz,bz,wr,ur,br,wn,un,bn}``, ``a1``, ``a2``, ``v`` and ``b``, with
weights as (in, out).
"""

import copy

import torch
from torch import nn

from ..ops.attention import inverted_dropout
from .base import RecModel


def gru_scan(p, xs, mask, h0):
    """Masked GRU over time: xs (B, T, D), mask (B, T) -> outputs (B, T, H), h_T.

    The input products and the three biases for all T come first, in one
    product and one add; a step is then one (B, H) x (H, 3H) product, one
    sigmoid over z and r together, n from one fused multiply-add, and
    (1 - z) n + z h as n + z (h - n): 8 device activities forward."""
    B, T, _ = xs.shape
    H = h0.shape[-1]
    w = torch.cat([p["wz"], p["wr"], p["wn"]], dim=1)
    xw = torch.addmm(torch.cat([p["bz"], p["br"], p["bn"]]), xs.reshape(B * T, -1), w).view(B, T, 3 * H)
    u = torch.cat([p["uz"], p["ur"], p["un"]], dim=1)
    h, outs = h0, []
    for t in range(T):
        hu = h @ u
        zr = torch.sigmoid(xw[:, t, :2 * H] + hu[:, :2 * H])
        n = torch.tanh(torch.addcmul(xw[:, t, 2 * H:], zr[:, H:], hu[:, 2 * H:]))
        h = torch.where(mask[:, t, None], torch.addcmul(n, zr[:, :H], h - n), h)
        outs.append(h)
    return torch.stack(outs, dim=1), h


class NARM(RecModel):
    batch_kind = "prefix"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.hidden_size = int(config.get("hidden_size", 100))
        self.embedding_dim = int(config.get("embedding_dim", config.get("emb_dim", 50)))
        self.dropout_input = float(config.get("dropout_input", 0.25))
        self.dropout_hidden = float(config.get("dropout_hidden", 0.5))
        e, h, dev = self.embedding_dim, self.hidden_size, self.device
        self.item_emb = nn.Parameter(torch.empty(n_items + 1, e, device=dev))
        shapes = {"wz": (e, h), "uz": (h, h), "bz": (h,), "wr": (e, h), "ur": (h, h), "br": (h,),
                  "wn": (e, h), "un": (h, h), "bn": (h,)}
        self.gru = nn.ParameterDict({k: nn.Parameter(torch.empty(s, device=dev)) for k, s in shapes.items()})
        self.a1 = nn.Parameter(torch.empty(h, h, device=dev))
        self.a2 = nn.Parameter(torch.empty(h, h, device=dev))
        self.v = nn.Parameter(torch.empty(h, 1, device=dev))
        self.b = nn.Parameter(torch.empty(e, 2 * h, device=dev))
        ctx = self.artifacts.get("ctx")
        self.ctx = None if ctx is None else torch.as_tensor(ctx, device=dev)

    @torch.no_grad()
    def init_weights(self, generator):
        """The JAX initializer's distributions, drawn from a CPU
        ``torch.Generator``: a normal(0, stddev) item table with a zero
        padding row, Xavier-uniform weights and zero GRU biases."""

        def draw(p, fn):
            host = torch.empty(p.shape)
            fn(host)
            p.copy_(host)

        draw(self.item_emb, lambda t: t.normal_(0.0, self.stddev, generator=generator))
        self.item_emb[0] = 0.0
        for name, p in self.named_parameters():
            if name == "item_emb":
                continue
            if name.startswith("gru.b"):
                p.zero_()
            else:
                draw(p, lambda t: nn.init.xavier_uniform_(t, generator=generator))
        return self

    def with_context(self, ctx):
        """A light copy (sharing the parameters) that scores against another
        per-user context matrix."""
        clone = copy.copy(self)
        clone.ctx = torch.as_tensor(ctx, device=self.item_emb.device)
        return clone

    def session_vector(self, seq, generator=None):
        """Encode (B, T) 1-indexed left-padded sequences into (B, 2H) session
        vectors; with a ``generator`` the input, then the hidden dropout."""
        mask = seq != 0
        embs = inverted_dropout(generator, self.item_emb[seq], self.dropout_input)
        h0 = embs.new_zeros(seq.shape[0], self.hidden_size)
        gru_out, ht = gru_scan(self.gru, embs, mask, h0)
        q1 = gru_out @ self.a1
        q2 = torch.where(mask[..., None], (ht @ self.a2)[:, None, :], 0.0)
        alpha = (torch.sigmoid(q1 + q2) @ self.v)[..., 0]
        c_local = (alpha[..., None] * gru_out * mask[..., None]).sum(dim=1)
        return inverted_dropout(generator, torch.cat([c_local, ht], dim=1), self.dropout_hidden)

    def _all_item_logits(self, c):
        return c @ (self.item_emb @ self.b).T  # (B, n_items + 1)

    def loss(self, batch, generator=None):
        """Cross-entropy over the catalog (pad row included) for each
        (prefix, target) example, target 1-indexed."""
        log_probs = torch.log_softmax(self._all_item_logits(self.session_vector(batch["seq"], generator)), dim=-1)
        return -log_probs.gather(1, batch["target"][:, None]).mean()

    def _session(self, users):
        if self.ctx is None:
            raise ValueError("NARM needs artifacts['ctx'] for scoring")
        return self.session_vector(self.ctx[users])

    def score_candidates(self, users, cand_items):
        """(U,), (U, C) dense 0-indexed candidates -> (U, C) logits."""
        return self._all_item_logits(self._session(users)).gather(1, cand_items + 1)

    def score_all(self, users):
        return self._all_item_logits(self._session(users))[:, 1:]

    def score_pairs(self, users, items):
        """Each pair's logit, as ``score_candidates`` gives it for one
        candidate (the JAX model has no pair score); each user's session is
        encoded once."""
        uniq, inv = torch.unique(users, return_inverse=True)
        return (self._session(uniq)[inv] * (self.item_emb[items + 1] @ self.b)).sum(dim=-1)
