"""Per-user chronological item sequences as padded context matrices.

Counterpart of ``SequentialData`` in
``beta_recsys_tpu/data/sequential_data.py``: train sequences, the SASRec
training arrays and evaluation contexts. Items are 1-indexed here (0 = padding),
so dense item ids from ``BaseData`` are shifted by +1. Chronology is forward:
oldest first, ordered by a stable sort on the timestamp.
"""

import numpy as np

from ..utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)
from .base_data import BaseData


class SequentialData(BaseData):
    """BaseData + padded per-user sequence arrays for sequence models."""

    def _train_events(self):
        """(users, items+1) of train, in stable timestamp order."""
        order = np.argsort(self.train[DEFAULT_TIMESTAMP_COL], kind="stable")
        return self.train[DEFAULT_USER_COL][order], self.train[DEFAULT_ITEM_COL][order] + 1

    def _grouped(self, users, items):
        """Stable group-by-user: (indptr, items) with each user's events in
        the order they were given."""
        order = np.argsort(users, kind="stable")
        counts = np.bincount(users, minlength=self.n_users)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return indptr, items[order]

    def get_train_seq(self):
        """Per-user chronological (oldest-first) 1-indexed item arrays."""
        indptr, items = self._grouped(*self._train_events())
        return np.split(items, indptr[1:-1])

    def train_seq_arrays(self, maxlen):
        """SASRec's training arrays: {"users": (n,), "seq": (n, maxlen),
        "pos": (n, maxlen)}, int32, for the users with >= 2 train items.
        ``seq`` holds a user's items but the newest and ``pos`` the items but
        the oldest (each input's next item), the last ``maxlen`` of each,
        right-aligned and 0-padded on the left; items 1-indexed."""
        indptr, items = self._grouped(*self._train_events())
        counts = np.diff(indptr)
        users = np.nonzero(counts >= 2)[0]
        row_of = np.full(self.n_users, -1)
        row_of[users] = np.arange(len(users))
        owner = np.repeat(np.arange(self.n_users), counts)
        from_end = indptr[owner + 1] - np.arange(len(items))  # 1 for the newest
        row = row_of[owner]
        seq = np.zeros((len(users), maxlen), dtype=np.int32)
        pos = np.zeros((len(users), maxlen), dtype=np.int32)
        # An item f-th from the end is input f - 1 from the end, if not the
        # newest, and target f from the end, if not the oldest.
        inp = (row >= 0) & (from_end >= 2) & (from_end - 1 <= maxlen)
        seq[row[inp], maxlen - (from_end[inp] - 1)] = items[inp]
        tgt = (row >= 0) & (from_end < counts[owner]) & (from_end <= maxlen)
        pos[row[tgt], maxlen - from_end[tgt]] = items[tgt]
        return {"users": users.astype(np.int32), "seq": seq, "pos": pos}

    def eval_context(self, maxlen, extra_df=None):
        """(n_users, maxlen) int32 context: each user's last ``maxlen`` train
        items, left-padded with 0. With ``extra_df`` (validation items for the
        final test), its positively-rated items are appended after the train
        sequence in frame order first."""
        users, items = self._train_events()
        if extra_df is not None:
            pos = extra_df[DEFAULT_RATING_COL] > 0
            users = np.concatenate([users, extra_df[DEFAULT_USER_COL][pos]])
            items = np.concatenate([items, extra_df[DEFAULT_ITEM_COL][pos] + 1])
        indptr, items = self._grouped(users, items)
        counts = np.diff(indptr)
        owner = np.repeat(np.arange(self.n_users), counts)
        from_end = indptr[owner + 1] - np.arange(len(items))  # 1 for the newest
        keep = from_end <= maxlen
        ctx = np.zeros((self.n_users, maxlen), dtype=np.int32)
        ctx[owner[keep], maxlen - from_end[keep]] = items[keep]
        return ctx
