"""Dense re-indexing of a split and the arrays evaluation and serving need.

Counterpart of ``BaseData`` in ``beta_recsys_tpu/data/base_data.py``, on
numpy + scipy frames (dicts of columns, see ``datasets/split_io.py``) in
place of pandas. It keeps the reference's semantics exactly:

- valid/test rows whose user or item never occurs in train are dropped;
- ratings ``> bin_thld`` become 1, the others keep their value;
- users and items get dense ids in order of FIRST APPEARANCE in train (as
  ``pd.Series.unique`` gives them), not in sorted order.
"""

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp

from ..utils.constants import DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_USER_COL


class TrainArrays(NamedTuple):
    """Train interactions as flat arrays (int32 dense ids, float32 ratings)."""

    users: np.ndarray
    items: np.ndarray
    ratings: np.ndarray


class EvalCandidates(NamedTuple):
    """Padded per-user candidate sets for ranked evaluation.

    users:     (U,)  int32 — dense user ids with >=1 relevant candidate.
    items:     (U, C) int32 — candidate item ids, padded with 0.
    relevance: (U, C) float32 — 1.0 where the candidate is a positive.
    ratings:   (U, C) float32 — raw ratings.
    mask:      (U, C) bool — valid candidate slots.
    """

    users: np.ndarray
    items: np.ndarray
    relevance: np.ndarray
    ratings: np.ndarray
    mask: np.ndarray


def first_appearance_unique(values):
    """Distinct values in order of first appearance (``pd.Series.unique``)."""
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def _dense_ids(values, pool):
    """Position of each value in ``pool``; every value must be in it."""
    order = np.argsort(pool, kind="stable")
    return order[np.searchsorted(pool, values, sorter=order)].astype(np.int64)


class BaseData:
    """A split re-indexed to dense ids, with the arrays scoring needs."""

    def __init__(self, split_dataset, bin_thld=0.0):
        train, valid, test = split_dataset
        valid = [valid] if isinstance(valid, dict) else list(valid)
        test = [test] if isinstance(test, dict) else list(test)
        self.user_pool = first_appearance_unique(train[DEFAULT_USER_COL])
        self.item_pool = first_appearance_unique(train[DEFAULT_ITEM_COL])
        self.n_users = len(self.user_pool)
        self.n_items = len(self.item_pool)
        # Copies throughout: the caller's frames are never modified.
        self.train = self._prepare(train, bin_thld)
        self.valid = [self._prepare(self._intersect(f), bin_thld) for f in valid]
        self.test = [self._prepare(self._intersect(f), bin_thld) for f in test]
        self._pos_csr_cache = None

    def _intersect(self, frame):
        """Drop rows whose user or item is unseen in train."""
        keep = np.isin(frame[DEFAULT_USER_COL], self.user_pool) & np.isin(
            frame[DEFAULT_ITEM_COL], self.item_pool
        )
        return {col: values[keep] for col, values in frame.items()}

    def _prepare(self, frame, bin_thld):
        """Binarize ratings above the threshold and map ids to dense ids."""
        out = dict(frame)
        ratings = np.array(frame[DEFAULT_RATING_COL])
        ratings[ratings > bin_thld] = 1.0
        out[DEFAULT_RATING_COL] = ratings
        out[DEFAULT_USER_COL] = _dense_ids(frame[DEFAULT_USER_COL], self.user_pool)
        out[DEFAULT_ITEM_COL] = _dense_ids(frame[DEFAULT_ITEM_COL], self.item_pool)
        return out

    def train_arrays(self):
        """Train interactions as flat arrays, for the trainers."""
        return TrainArrays(
            users=self.train[DEFAULT_USER_COL].astype(np.int32),
            items=self.train[DEFAULT_ITEM_COL].astype(np.int32),
            ratings=self.train[DEFAULT_RATING_COL].astype(np.float32),
        )

    def pos_csr(self):
        """Per-user sorted positive items as CSR (indptr, items), int32: the
        train pairs lexsorted by (user, item). Feeds the rejection sampler's
        membership test (``ops/sampling.make_membership_test``)."""
        if self._pos_csr_cache is None:
            users = self.train[DEFAULT_USER_COL].astype(np.int64)
            items = self.train[DEFAULT_ITEM_COL].astype(np.int64)
            order = np.lexsort((items, users))
            counts = np.bincount(users, minlength=self.n_users)
            indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
            self._pos_csr_cache = (indptr, items[order].astype(np.int32))
        return self._pos_csr_cache

    def pos_bitmask(self):
        """Dense (n_users, n_items) bool positive mask (small catalogs only)."""
        mask = np.zeros((self.n_users, self.n_items), dtype=bool)
        mask[self.train[DEFAULT_USER_COL], self.train[DEFAULT_ITEM_COL]] = True
        return mask

    def user_item_csr(self):
        """Binarized user x item train interactions as scipy CSR."""
        return sp.csr_matrix(
            (
                self.train[DEFAULT_RATING_COL].astype(np.float32),
                (self.train[DEFAULT_USER_COL], self.train[DEFAULT_ITEM_COL]),
            ),
            shape=(self.n_users, self.n_items),
        )

    def eval_candidates(self, frame, pad_to=None):
        """Padded candidate arrays of an evaluation frame.

        Only users with at least one relevant (rating >= 1) candidate are
        kept; each user's candidates keep their frame order in the slots
        (the ranking breaks ties by slot).
        """
        users = frame[DEFAULT_USER_COL]
        keep = np.isin(users, users[frame[DEFAULT_RATING_COL] >= 1])
        users = users[keep]
        uniq_users, user_idx = np.unique(users, return_inverse=True)
        n_u = len(uniq_users)
        order = np.argsort(user_idx, kind="stable")
        counts = np.bincount(user_idx, minlength=n_u)
        slot = np.empty(len(users), dtype=np.int64)
        slot[order] = np.arange(len(users)) - np.repeat(np.cumsum(counts) - counts, counts)
        C = pad_to or (int(counts.max()) if n_u else 0)

        items = np.zeros((n_u, C), dtype=np.int32)
        ratings = np.zeros((n_u, C), dtype=np.float32)
        mask = np.zeros((n_u, C), dtype=bool)
        items[user_idx, slot] = frame[DEFAULT_ITEM_COL][keep]
        ratings[user_idx, slot] = frame[DEFAULT_RATING_COL][keep]
        mask[user_idx, slot] = True
        relevance = (ratings >= 1).astype(np.float32) * mask
        return EvalCandidates(
            users=uniq_users.astype(np.int32),
            items=items,
            relevance=relevance,
            ratings=ratings,
            mask=mask,
        )
