"""Basket (user, item_i, item_j) triples for the grocery models (numpy only).

Counterpart of ``beta_recsys_tpu/utils/triple_sampler.py`` (the reference's
``beta_rec/utils/triple_sampler.py``): draw baskets uniformly, then two
items of each drawn basket with replacement; the time-bucketed variant
splits the baskets into ``time_step`` buckets by their mean timestamp and
draws ``n_sample // time_step`` triples a bucket. Baskets are the (order,
user) groups in sorted key order, each keeping its items in the frame's row
order, as pandas' ``groupby(sort=True)`` gives them, so the same seed draws
the JAX package's triples bit for bit. The CSV cache keeps its columns
(UID, PID1, PID2[, T]).
"""

import os

import numpy as np

from .constants import DEFAULT_ITEM_COL, DEFAULT_ORDER_COL, DEFAULT_TIMESTAMP_COL, DEFAULT_USER_COL


def _basket_arrays(train):
    """(basket users, items of every basket back to back, basket offsets,
    basket lengths, basket order ids), the baskets sorted by (order, user)."""
    orders = np.asarray(train[DEFAULT_ORDER_COL])
    users = np.asarray(train[DEFAULT_USER_COL])
    rows = np.lexsort((users, orders))  # stable: a basket's items keep their row order
    o, u = orders[rows], users[rows]
    offsets = np.flatnonzero(np.r_[True, (o[1:] != o[:-1]) | (u[1:] != u[:-1])])
    lengths = np.diff(np.r_[offsets, len(rows)])
    return u[offsets], np.asarray(train[DEFAULT_ITEM_COL])[rows], offsets, lengths, o[offsets]


def _sample_from_baskets(users, flat_items, offsets, lengths, basket_idx, rng):
    """Two items, with replacement, of each indexed basket."""
    li = lengths[basket_idx]
    off = offsets[basket_idx]
    i_pos = off + (rng.random(len(basket_idx)) * li).astype(np.int64)
    j_pos = off + (rng.random(len(basket_idx)) * li).astype(np.int64)
    return users[basket_idx], flat_items[i_pos], flat_items[j_pos]


class Sampler:
    """Draw basket triples, optionally cached in a CSV file. A result is a
    dict of int64 columns "UID", "PID1", "PID2" (and "T", the time bucket)."""

    def __init__(self, df_train, sample_file, n_sample, dump=True, load_save=False, seed=None):
        self.sample_file = sample_file
        self.df_train = df_train
        self.n_sample = n_sample
        self.dump = dump
        self.load_save = load_save
        self.rng = np.random.default_rng(seed)

    def sample(self):
        """``n_sample`` triples over baskets drawn uniformly."""
        if self.load_save and os.path.exists(self.sample_file):
            return self.load_triples_from_file(self.sample_file)
        users, flat_items, offsets, lengths, _ = _basket_arrays(self.df_train)
        basket_idx = self.rng.integers(0, len(lengths), size=self.n_sample)
        u, i, j = _sample_from_baskets(users, flat_items, offsets, lengths, basket_idx, self.rng)
        return self._dumped({"UID": u, "PID1": i, "PID2": j})

    def sample_by_time(self, time_step):
        """Time-bucketed triples: the baskets sorted stably by their order's
        mean timestamp, split into ``time_step`` buckets (the first takes the
        remainder), ``n_sample // time_step`` triples drawn from each."""
        if self.load_save and os.path.exists(self.sample_file):
            return self.load_triples_from_file(self.sample_file)
        if time_step == 0:
            return self.sample()
        users, flat_items, offsets, lengths, order_ids = _basket_arrays(self.df_train)
        # An order's mean timestamp: integer sums below 2^53 are exact in
        # float64, so this equals pandas' groupby mean.
        uniq, inv = np.unique(np.asarray(self.df_train[DEFAULT_ORDER_COL]), return_inverse=True)
        sums = np.bincount(inv, weights=np.asarray(self.df_train[DEFAULT_TIMESTAMP_COL], dtype=np.float64))
        order_ts = (sums / np.bincount(inv))[np.searchsorted(uniq, order_ids)]
        time_order = np.argsort(order_ts, kind="stable")
        n_orders = len(lengths)
        n_per_t = n_orders // time_step
        n_sample_per_t = self.n_sample // time_step
        rest = n_orders - time_step * n_per_t

        parts = []
        for t in range(time_step):
            lo, hi = (0, rest) if t == 0 else (t * n_per_t + rest, (t + 1) * n_per_t + rest)
            if hi <= lo:
                continue
            pick = self.rng.integers(lo, hi, size=n_sample_per_t)
            u, i, j = _sample_from_baskets(users, flat_items, offsets, lengths, time_order[pick], self.rng)
            parts.append((u, i, j, np.full(len(u), t, dtype=np.int64)))
        return self._dumped({key: np.concatenate([p[c] for p in parts]).astype(np.int64)
                             for c, key in enumerate(("UID", "PID1", "PID2", "T"))})

    def _dumped(self, triples):
        triples = {key: np.asarray(values, dtype=np.int64) for key, values in triples.items()}
        if self.dump:
            np.savetxt(self.sample_file, np.column_stack(list(triples.values())), fmt="%d", delimiter=",",
                       header=",".join(triples), comments="")
        return triples

    def load_triples_from_file(self, triple_file):
        """Cached triples from a CSV file with a header line."""
        with open(triple_file) as f:
            names = f.readline().strip().split(",")
            values = np.loadtxt(f, delimiter=",", dtype=np.int64, ndmin=2).reshape(-1, len(names))
        return {name: values[:, c] for c, name in enumerate(names)}
