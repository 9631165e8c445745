"""Host-side batch iterators (numpy), the counterparts of the JAX package's
``beta_recsys_tpu/data/data_loaders.py``.

The trainers do not use them: each trainer forms its epoch's batches itself
(``core/train_engine.py``). They serve host-side experiments and, given the
same numpy generator, yield the JAX package's batches bit for bit over the
port's ``BaseData`` (``pos_bitmask``, ``user_item_csr``).
"""

import numpy as np

from ..utils.constants import DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_USER_COL


class RatingDataset:
    """Aligned (user, item, rating) arrays."""

    def __init__(self, users, items, ratings):
        self.users = np.asarray(users, dtype=np.int64)
        self.items = np.asarray(items, dtype=np.int64)
        self.ratings = np.asarray(ratings, dtype=np.float32)

    def __len__(self):
        return len(self.users)

    def __getitem__(self, idx):
        return self.users[idx], self.items[idx], self.ratings[idx]


class PairwiseNegativeDataset:
    """Aligned (user, pos_item, neg_item) arrays."""

    def __init__(self, users, pos_items, neg_items):
        self.users = np.asarray(users, dtype=np.int64)
        self.pos_items = np.asarray(pos_items, dtype=np.int64)
        self.neg_items = np.asarray(neg_items, dtype=np.int64)

    def __len__(self):
        return len(self.users)

    def __getitem__(self, idx):
        return self.users[idx], self.pos_items[idx], self.neg_items[idx]


def _batched(arrays, batch_size, shuffle, rng):
    n = len(arrays[0])
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    for start in range(0, n, batch_size):
        b = idx[start:start + batch_size]
        yield tuple(a[b] for a in arrays)


def _train(data, col, dtype):
    return np.asarray(data.train[col], dtype=dtype)


def instance_bpr_loader(data, batch_size, rng=None, num_rounds=1):
    """(users, pos_items, neg_items) batches of the shuffled train pairs,
    each negative uniform, redrawn ``num_rounds`` times where it is a
    positive of its user."""
    rng = rng or np.random.default_rng()
    users, pos = _train(data, DEFAULT_USER_COL, np.int64), _train(data, DEFAULT_ITEM_COL, np.int64)
    mask = data.pos_bitmask()
    neg = rng.integers(0, data.n_items, len(users))
    for _ in range(num_rounds):
        neg = np.where(mask[users, neg], rng.integers(0, data.n_items, len(users)), neg)
    return _batched((users, pos, neg.astype(np.int64)), batch_size, True, rng)


def instance_bce_loader(data, num_negative, batch_size, rng=None):
    """(users, items, labels) batches: each train pair with its rating and
    ``num_negative`` uniform negatives a pair (redrawn once where a
    positive) labelled 0, shuffled together."""
    rng = rng or np.random.default_rng()
    users, pos = _train(data, DEFAULT_USER_COL, np.int64), _train(data, DEFAULT_ITEM_COL, np.int64)
    ratings = _train(data, DEFAULT_RATING_COL, np.float32)
    mask = data.pos_bitmask()
    rep_users = np.repeat(users, num_negative)
    neg = rng.integers(0, data.n_items, len(rep_users))
    neg = np.where(mask[rep_users, neg], rng.integers(0, data.n_items, len(rep_users)), neg)
    all_users = np.concatenate([users, rep_users])
    all_items = np.concatenate([pos, neg])
    all_labels = np.concatenate([ratings, np.zeros(len(neg), np.float32)])
    return _batched((all_users, all_items, all_labels), batch_size, True, rng)


def instance_vae_loader(data, batch_size, rng=None, shuffle=True):
    """(user ids int32, dense binarized user x item rows float32) batches,
    the users shuffled; each batch's rows densified on demand."""
    rng = rng or np.random.default_rng()
    csr = data.user_item_csr()
    csr.data[:] = 1.0
    order = np.arange(data.n_users)
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        yield idx.astype(np.int32), np.asarray(csr[idx].todense(), dtype=np.float32)


def instance_mul_neg_loader(data, num_negative, batch_size, rng=None):
    """(users, pos_items, neg_items (B, num_negative)) batches, each negative
    redrawn once where a positive of its user."""
    rng = rng or np.random.default_rng()
    users, pos = _train(data, DEFAULT_USER_COL, np.int64), _train(data, DEFAULT_ITEM_COL, np.int64)
    mask = data.pos_bitmask()
    neg = rng.integers(0, data.n_items, (len(users), num_negative))
    neg = np.where(mask[users[:, None], neg], rng.integers(0, data.n_items, neg.shape), neg)
    return _batched((users, pos, neg), batch_size, True, rng)
