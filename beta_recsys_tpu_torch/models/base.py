"""The recommender-model contract as an ``nn.Module``.

Counterpart of ``RecModel`` in ``beta_recsys_tpu/models/base.py``. There a
model is a family of pure functions over an explicit params tree; here the
module holds its parameters, and the scoring methods take only ids. Every
scoring method runs without autograd bookkeeping when called under
``torch.no_grad()``, as the serving paths do.

A model with a factorized form returns its final (user, item) tables from
``user_item_embeddings``; the scoring defaults are then dot products of
those tables, as in the JAX ``RecModel``. Inside ``holding_embeddings()``
the tables are computed once for every scoring call (a graph model
propagates once per ``recommend()``, not once per user block).
"""

from contextlib import contextmanager

import torch
from torch import nn

from ..device import resolve_device


class RecModel(nn.Module):
    """Static hyperparameters + parameters + the scoring contract."""

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        """``config`` is the model section (mapping); ``artifacts`` carries
        derived data (e.g. sequence contexts) explicitly, never through the
        config. Parameters are created on ``device``: the GPU when it is
        None (``resolve_device``, which raises without CUDA)."""
        super().__init__()
        self.config = config
        self.n_users = n_users
        self.n_items = n_items
        self.artifacts = artifacts or {}
        self.device = resolve_device(device)
        self.emb_dim = int(config.get("emb_dim", 64))
        self.stddev = float(config.get("stddev", 0.1))
        self._held = None

    def load_trimmed(self, state_dict):
        """``load_state_dict`` of a state whose row tables may carry pad rows
        (a sharded run pads them to a multiple of the model axis:
        ``parallel/embedding.pad_table``). Rows past the model's own are cut, so
        the model never holds pad rows."""
        own = self.state_dict()
        tables = self.row_tables() if hasattr(self, "row_tables") else {}
        state = {
            name: value[: own[name].shape[0]] if name in tables and value.shape[1:] == own[name].shape[1:] else value
            for name, value in state_dict.items()
        }
        return self.load_state_dict(state)

    def retrieval_score_transform(self, scores):
        """Map raw factorized retrieval scores onto ``score_pairs``' scale.
        Identity unless a model's ``score_pairs`` adds a nonlinearity."""
        return scores

    def user_item_embeddings(self):
        """(user_emb, item_emb) final tables, or None if the model has no
        factorized form (then ``score_pairs`` must be overridden)."""
        return None

    @contextmanager
    def holding_embeddings(self):
        """Within the block, the scoring calls share one computation of
        ``user_item_embeddings`` (made at the first call); the parameters must
        not change inside it."""
        self._held = {}
        try:
            yield self
        finally:
            self._held = None

    def _embeddings(self):
        if self._held is None:
            return self.user_item_embeddings()
        if "tables" not in self._held:
            self._held["tables"] = self.user_item_embeddings()
        return self._held["tables"]

    def user_item_embeddings_trimmed(self):
        """``user_item_embeddings`` cut to (n_users, n_items) rows, so no pad
        row is ever scored (a no-op for exact-size tables)."""
        embs = self._embeddings()
        if embs is None:
            return None
        u_emb, i_emb = embs
        return u_emb[: self.n_users], i_emb[: self.n_items]

    def score_pairs(self, users, items):
        """Score aligned (user, item) pairs -> (...,) float scores."""
        embs = self._embeddings()
        if embs is None:
            raise NotImplementedError
        u_emb, i_emb = embs
        return (u_emb[users] * i_emb[items]).sum(dim=-1)

    def score_candidates(self, users, cand_items):
        """Score per-user candidate sets: users (U,), cand_items (U, C) -> (U, C)."""
        embs = self._embeddings()
        if embs is not None:
            u_emb, i_emb = embs
            return torch.einsum("ud,ucd->uc", u_emb[users], i_emb[cand_items])
        users_b = users[:, None].expand(cand_items.shape)
        return self.score_pairs(users_b, cand_items)

    def score_all(self, users):
        """Full-catalog scores: users (U,) -> (U, n_items)."""
        embs = self.user_item_embeddings_trimmed()
        if embs is not None:
            u_emb, i_emb = embs
            return u_emb[users] @ i_emb.T
        cand = torch.arange(self.n_items, device=users.device)
        return self.score_candidates(users, cand[None, :].expand(users.shape[0], -1))
