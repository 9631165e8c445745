"""UserKNN and ItemKNN: neighbourhood models with nothing to train.

Counterpart of ``beta_recsys_tpu/models/knn.py``: R is the dense 0/1
float32 (n_users, n_items) interaction matrix on the device (from
``artifacts["interactions"]``, a scipy matrix or an array). UserKNN scores
a user's items by the overlaps |items_u & items_v| / sqrt(|items_v|) of its
``neighbourhood_size`` nearest users v (every user whose overlap reaches
the k-th largest: ties stay in) times R; ItemKNN by the user's row times
the item-item matrix |users_i & users_j| / sqrt(|users_j|), computed once,
with no neighbourhood cut (as in the JAX package and the reference). Seen
items score ``NEG_INF``. The batch kind "none" has no epoch loop; the
parameters are one 0-d ``_``, for the checkpoint's shape.
"""

import numpy as np
import torch
from torch import nn

from ..ops.metrics import NEG_INF
from .base import RecModel


class _KNNBase(RecModel):
    batch_kind = "none"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.k = int(config.get("neighbourhood_size", 50))
        R = self.artifacts["interactions"]
        if hasattr(R, "toarray"):
            R = R.toarray()
        self.R = torch.as_tensor((np.asarray(R) > 0).astype(np.float32), device=self.device)
        self._ = nn.Parameter(torch.zeros((), device=self.device))

    @torch.no_grad()
    def init_weights(self, generator):
        self._.zero_()
        return self

    def loss(self, batch, generator=None):
        return torch.zeros((), device=self.device)

    def _user_scores(self, users):
        raise NotImplementedError

    def score_candidates(self, users, cand_items):
        return self._user_scores(users).gather(1, cand_items)

    def score_all(self, users):
        return self._user_scores(users)


class UserKNN(_KNNBase):
    """Similarity-weighted sums over each user's nearest users."""

    def _user_scores(self, users):
        R = self.R
        rows = R[users]
        overlap = (rows @ R.T) / torch.sqrt(torch.clamp(R.sum(dim=1), min=1.0))[None, :]
        # The k-th largest overlap (the JAX package's sort(...)[:, -k]; a k
        # past the user count reads the smallest, as its clamped index does).
        kth = torch.topk(overlap, min(self.k, overlap.shape[1]), dim=1).values[:, -1:]
        scores = torch.where(overlap >= kth, overlap, 0.0) @ R
        return torch.where(rows > 0, NEG_INF, scores)


class ItemKNN(_KNNBase):
    """Sums of item-item overlap similarities over each user's items."""

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.sim = (self.R.T @ self.R) / torch.sqrt(torch.clamp(self.R.sum(dim=0), min=1.0))[None, :]

    def _user_scores(self, users):
        rows = self.R[users]
        return torch.where(rows > 0, NEG_INF, rows @ self.sim)
