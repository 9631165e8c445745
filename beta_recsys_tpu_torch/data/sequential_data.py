"""Per-user chronological item sequences as padded context matrices.

Counterpart of ``SequentialData`` in
``beta_recsys_tpu/data/sequential_data.py``: train sequences, the SASRec
training arrays, NARM's (prefix, target) examples, TiSASRec's per-user time
scales and clipped interval matrices, and evaluation contexts. Items are
1-indexed here (0 = padding), so dense item ids from ``BaseData`` are
shifted by +1. Chronology is forward: oldest first, ordered by a stable sort
on the timestamp. Every array is built with numpy at once, with the JAX
package's values and dtypes.
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

    def _train_events(self, with_times=False):
        """(users, items+1) of train, in stable timestamp order; with
        ``with_times`` also the int64 timestamps."""
        order = np.argsort(self.train[DEFAULT_TIMESTAMP_COL], kind="stable")
        events = (self.train[DEFAULT_USER_COL][order], self.train[DEFAULT_ITEM_COL][order] + 1)
        if with_times:
            events += (self.train[DEFAULT_TIMESTAMP_COL][order].astype(np.int64),)
        return events

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

    def prefix_target_arrays(self, maxlen):
        """NARM's examples: {"seq": (n, maxlen), "target": (n,)}, int32. Every
        position t >= 1 of each user's train sequence, users in id order,
        gives one example: the last ``maxlen`` items before t, left-padded
        with 0, and the item at t."""
        indptr, items = self._grouped(*self._train_events())
        owner = np.repeat(np.arange(self.n_users), np.diff(indptr))
        event = np.arange(len(items))
        at = event[event > indptr[owner]]  # the targets' events, position t >= 1
        back = maxlen - np.arange(maxlen)  # column j holds the item maxlen - j before t
        src = at[:, None] - back[None, :]
        valid = src >= indptr[owner[at]][:, None]
        seq = np.where(valid, items[np.maximum(src, 0)], 0).astype(np.int32)
        return {"seq": seq, "target": items[at].astype(np.int32)}

    def _scaled_times(self):
        """(users, items+1, scaled times) of train in stable timestamp order:
        each user's timestamps minus the user's first, over the user's
        smallest nonzero gap (1 where there is none), rounded half to even,
        plus 1 (the reference's personalised time scale)."""
        users, items, ts = self._train_events(with_times=True)
        order = np.argsort(users, kind="stable")
        u, t = users[order], ts[order]  # each user's times ascend
        first = np.ones(len(u), dtype=bool)
        first[1:] = u[1:] != u[:-1]
        gaps = np.diff(t, prepend=t[:1])
        big = np.iinfo(np.int64).max
        scale = np.full(self.n_users, big, dtype=np.int64)
        np.minimum.at(scale, u, np.where(first | (gaps <= 0), big, gaps))
        scale[scale == big] = 1
        t_min = np.zeros(self.n_users, dtype=np.int64)
        t_min[u[first]] = t[first]
        scaled = np.empty(len(ts), dtype=np.int64)
        scaled[order] = np.round((t - t_min[u]) / scale[u]).astype(np.int64) + 1
        return users, items, scaled

    def _user_times(self):
        """Per-user scaled timestamps aligned with ``get_train_seq``: a list
        of int64 arrays (``_scaled_times``)."""
        users, _, scaled = self._scaled_times()
        indptr, times = self._grouped(users, scaled)
        return np.split(times, indptr[1:-1])

    @staticmethod
    def _clipped_interval_matrix(time_row, time_span):
        """|t_i - t_j| over the last axis of ``time_row`` (..., T), clipped
        to ``time_span``: (..., T, T) int32."""
        time_row = np.asarray(time_row, dtype=np.int64)
        diff = np.abs(time_row[..., :, None] - time_row[..., None, :])
        return np.minimum(diff, time_span).astype(np.int32)

    @classmethod
    def _interval_matrices(cls, time_rows, time_span, rows_a_chunk=1024):
        """``_clipped_interval_matrix`` of each row of (n, T) times, a chunk
        of rows at a time (an int64 (chunk, T, T) intermediate)."""
        n, t = time_rows.shape
        mats = np.empty((n, t, t), dtype=np.int32)
        for start in range(0, n, rows_a_chunk):
            mats[start:start + rows_a_chunk] = cls._clipped_interval_matrix(
                time_rows[start:start + rows_a_chunk], time_span)
        return mats

    def tisasrec_arrays(self, maxlen, time_span):
        """TiSASRec's training arrays: ``train_seq_arrays`` plus
        "time_matrix" (n, maxlen, maxlen) int32, the clipped intervals
        between the scaled times of each row's ``seq`` positions (0 at
        padding), aligned with ``seq``."""
        base = self.train_seq_arrays(maxlen)
        users, _, scaled = self._scaled_times()
        indptr, times = self._grouped(users, scaled)
        counts = np.diff(indptr)
        row_of = np.full(self.n_users, -1)
        row_of[base["users"]] = np.arange(len(base["users"]))
        owner = np.repeat(np.arange(self.n_users), counts)
        from_end = indptr[owner + 1] - np.arange(len(times))  # 1 for the newest
        row = row_of[owner]
        # The positions of seq: every time but the newest, the last maxlen.
        keep = (row >= 0) & (from_end >= 2) & (from_end - 1 <= maxlen)
        time_rows = np.zeros((len(base["users"]), maxlen), dtype=np.int64)
        time_rows[row[keep], maxlen - (from_end[keep] - 1)] = times[keep]
        base["time_matrix"] = self._interval_matrices(time_rows, time_span)
        return base

    def tisasrec_eval_context(self, maxlen, time_span, extra_df=None):
        """(ctx, ctx_time_matrix) for TiSASRec's scoring: (n_users, maxlen)
        int32 items and (n_users, maxlen, maxlen) int32 clipped intervals.
        With ``extra_df`` (validation items for the final test) its
        positively-rated items are appended in frame order, the k-th of a
        user at the user's last scaled time + k (0 + k without train
        items), so position p of the context is row and column p of the
        matrix."""
        users, items, times = self._scaled_times()
        if extra_df is not None:
            pos = extra_df[DEFAULT_RATING_COL] > 0
            extra_users = extra_df[DEFAULT_USER_COL][pos].astype(np.int64)
            last = np.zeros(self.n_users, dtype=np.int64)
            np.maximum.at(last, users, times)  # a user's times ascend: the newest
            order = np.argsort(extra_users, kind="stable")
            grouped = extra_users[order]
            rank = np.arange(len(grouped)) - np.searchsorted(grouped, grouped) + 1
            extra_times = np.empty(len(grouped), dtype=np.int64)
            extra_times[order] = last[grouped] + rank
            users = np.concatenate([users, extra_users])
            items = np.concatenate([items, extra_df[DEFAULT_ITEM_COL][pos] + 1])
            times = np.concatenate([times, extra_times])
        order = np.argsort(users, kind="stable")
        counts = np.bincount(users, minlength=self.n_users)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        items, times = items[order], times[order]
        owner = np.repeat(np.arange(self.n_users), counts)
        from_end = indptr[owner + 1] - np.arange(len(items))  # 1 for the newest
        keep = from_end <= maxlen
        ctx = np.zeros((self.n_users, maxlen), dtype=np.int32)
        ctx[owner[keep], maxlen - from_end[keep]] = items[keep]
        time_rows = np.zeros((self.n_users, maxlen), dtype=np.int64)
        time_rows[owner[keep], maxlen - from_end[keep]] = times[keep]
        return ctx, self._interval_matrices(time_rows, time_span)

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
