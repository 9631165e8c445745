"""Split strategies, k-core filters, evaluation negatives and the split cache.

Counterpart of ``beta_recsys_tpu/datasets/data_split.py`` on frames that are
dicts of numpy columns (``utils/common.py``) in place of pandas DataFrames.
Every written frame keeps the JAX package's row order, which is part of the
result (``BaseData`` numbers ids by first appearance):

- ``sklearn.utils.shuffle`` is a permutation drawn from numpy's global
  generator (``np.random.permutation``), as is the host library's seed
  (``np.random.randint(2**31)``);
- ``sort_values`` on one column is pandas' ``nargsort``: numpy's quicksort,
  which is not stable, on the reversed column when descending (``_sort``);
- ``groupby`` visits sorted keys (``sort=False``: first appearance), each
  group's rows in frame order; ``pd.unique`` and ``drop_duplicates`` keep
  first appearances;
- ``value_counts().to_dict()`` orders by count, descending, ties in first
  appearance: the ``AliasTable``'s index, which decides the item a draw names.

The k-core and the implicit-feedback negative draws run in the host library
(``datasets/host.py``) unless the caller passes ``use_native=False``.
"""

import math
import os

import numpy as np

from ..utils.alias_table import AliasTable
from ..utils.common import get_dataframe_from_npz, save_dataframe_as_npz
from ..utils.constants import (
    DEFAULT_FLAG_COL,
    DEFAULT_ITEM_COL,
    DEFAULT_ORDER_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)
from . import host

# -- frames ------------------------------------------------------------------------


def n_rows(frame):
    return len(next(iter(frame.values())))


def take(frame, rows):
    """The frame's rows ``rows`` (indices or a boolean mask), in that order."""
    return {col: np.asarray(values)[rows] for col, values in frame.items()}


def shuffle(frame):
    """``sklearn.utils.shuffle``: the rows in a permutation drawn from numpy's
    global generator."""
    return take(frame, np.random.permutation(n_rows(frame)))


def _shuffled(values):
    return np.asarray(values)[np.random.permutation(len(values))]


def _sort(values, ascending=True):
    """pandas' ``nargsort`` with quicksort: the order of ``sort_values``."""
    values = np.asarray(values)
    idx = np.arange(len(values))
    if ascending:
        return idx[values.argsort(kind="quicksort")]
    return idx[::-1][values[::-1].argsort(kind="quicksort")][::-1]


def first_unique(values):
    """``pd.unique``: the distinct values in order of first appearance."""
    values = np.asarray(values)
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def _codes(values):
    """Dense codes of the values (any consistent numbering) and their count."""
    uniq, inverse = np.unique(np.asarray(values), return_inverse=True)
    return inverse.reshape(-1).astype(np.int64), len(uniq)


def groups(keys, sort=True):
    """``groupby`` order: [(key, row indices in frame order)], keys sorted
    or, with ``sort=False``, in order of first appearance."""
    keys = np.asarray(keys)
    uniq, first, inverse = np.unique(keys, return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind="stable")
    bounds = np.r_[0, np.cumsum(np.bincount(inverse, minlength=len(uniq)))]
    members = [order[bounds[g]:bounds[g + 1]] for g in range(len(uniq))]
    visit = range(len(uniq)) if sort else np.argsort(first, kind="stable")
    return [(uniq[g], members[g]) for g in visit]


def value_counts(values):
    """``value_counts().to_dict()``: {value: count}, counts descending, ties
    in order of first appearance."""
    values = np.asarray(values)
    uniq, first, counts = np.unique(values, return_index=True, return_counts=True)
    by_first = np.argsort(first, kind="stable")
    uniq, counts = uniq[by_first], counts[by_first]
    order = np.argsort(-counts, kind="stable")
    return dict(zip(uniq[order].tolist(), counts[order].tolist()))


# -- filters -----------------------------------------------------------------------


def filter_by_count(df, group_col, filter_col, num):
    """Keep rows whose ``group_col`` value has >= ``num`` distinct
    ``filter_col`` values."""
    g, n_g = _codes(df[group_col])
    f, n_f = _codes(df[filter_col])
    pairs = np.unique(g * n_f + f)
    distinct = np.bincount(pairs // n_f, minlength=n_g)
    return take(df, distinct[g] >= num)


def check_data_available(data):
    """Raise if the filtered dataset has no interactions left."""
    if n_rows(data) < 1:
        raise RuntimeError(
            "This dataset contains no interaction after filtering. "
            "Please check the default filter setup of this split!"
        )


def _kcore_mask(df, min_u_c, min_i_c, min_o_c, use_native):
    """The distinct-count k-core's surviving rows. The filter has one
    maximal fixed point (a dropped row's counts only fall), so dropping
    every violating row at once, as the host library does, equals pandas'
    sequential loop."""
    u, n_u = _codes(df[DEFAULT_USER_COL])
    i, n_i = _codes(df[DEFAULT_ITEM_COL])
    pair_ids, n_pairs = _codes(u * n_i + i)
    uo_ids, n_uos = None, 0
    if min_o_c > 0:
        o, n_o = _codes(df[DEFAULT_ORDER_COL])
        uo_ids, n_uos = _codes(u * n_o + o)
    fn = host.kcore_filter_distinct if use_native else host.kcore_filter_distinct_numpy
    return fn(u, i, pair_ids, uo_ids, n_u, n_i, n_pairs, n_uos, min_u_c, min_i_c, min_o_c)


def filter_user_item(df, min_u_c=5, min_i_c=5, use_native=True):
    """Iterative k-core: users with >= ``min_i_c`` distinct items, items with
    >= ``min_u_c`` distinct users, to the fixed point."""
    data = take(df, _kcore_mask(df, min_u_c, min_i_c, 0, use_native))
    check_data_available(data)
    return data


def filter_user_item_order(df, min_u_c=5, min_i_c=5, min_o_c=5, use_native=True):
    """The k-core that also needs each user to have >= ``min_o_c`` orders."""
    data = take(df, _kcore_mask(df, min_u_c, min_i_c, min_o_c, use_native))
    check_data_available(data)
    return data


# -- evaluation negatives ------------------------------------------------------------


def feed_neg_sample(data, negative_num, item_sampler, use_native=True):
    """Each user's distinct positives (rating kept, or 1) followed by
    ``negative_num`` items drawn from ``item_sampler`` that the user never
    had (rating 0); with ``negative_num < 0`` every other item of the frame.
    The returned frame is shuffled. Implicit feedback (one rating value) with
    ``use_native`` draws in the host library (one ``std::mt19937_64`` seeded
    from numpy's global generator); otherwise the alias table's host draws
    of ``negative_num`` + n_pos labels, positives removed, truncated."""
    ratings = np.asarray(data[DEFAULT_RATING_COL])
    unique_rating_num = len(np.unique(ratings))
    if use_native and negative_num > 0 and unique_rating_num == 1:
        try:
            return _feed_neg_sample_native(data, negative_num, item_sampler)
        except host.InsufficientNegatives:
            pass  # too few distinct negatives for a user: the truncating path, as in the JAX package
    items = np.asarray(data[DEFAULT_ITEM_COL])
    unique_item_arr = first_unique(items)
    users_out, items_out, ratings_out = [], [], []
    for u, rows in groups(data[DEFAULT_USER_COL]):
        g_items = items[rows]
        if unique_rating_num != 1:  # the first-seen rating of each distinct positive
            _, first = np.unique(g_items, return_index=True)
            keep = rows[np.sort(first)]
            pos_items, pos_ratings = items[keep], ratings[keep]
        else:
            pos_items = first_unique(g_items)
            pos_ratings = np.ones(len(pos_items))
        pos_set = set(pos_items.tolist())
        if negative_num < 0:
            neg_items = np.asarray([it for it in unique_item_arr.tolist() if it not in pos_set])
        else:
            draws = item_sampler.sample(negative_num + len(pos_items), 1, True)
            neg_items = np.asarray([d for d in draws if d not in pos_set][:negative_num])
        users_out.append(np.full(len(pos_items) + len(neg_items), u))
        items_out.append(np.concatenate([pos_items, neg_items]))
        ratings_out.append(np.concatenate([pos_ratings, np.zeros(len(neg_items))]))
    return shuffle({DEFAULT_USER_COL: np.concatenate(users_out), DEFAULT_ITEM_COL: np.concatenate(items_out),
                    DEFAULT_RATING_COL: np.concatenate(ratings_out)})


def _label_positions(labels, values):
    """Each value's position in ``labels`` (distinct), -1 where absent."""
    order = np.argsort(labels, kind="stable")
    pos = order[np.minimum(np.searchsorted(labels, values, sorter=order), len(labels) - 1)]
    return np.where(labels[pos] == values, pos, -1).astype(np.int64)


def _feed_neg_sample_native(data, negative_num, item_sampler):
    """The host library draws and rejects the alias table's positions, and
    the negatives are its labels: items of the frame's own type. (The JAX
    package passes the ids themselves as int64, so string item ids come back
    as ints or raise; ROADMAP.md, notes on the reference.)"""
    labels = np.asarray(item_sampler.index2Label)
    users_all, items_all = np.asarray(data[DEFAULT_USER_COL]), np.asarray(data[DEFAULT_ITEM_COL])
    # The distinct (user, item) pairs in order of first appearance.
    u, n_u = _codes(users_all)
    i, n_i = _codes(items_all)
    _, first = np.unique(u * n_i + i, return_index=True)
    first = np.sort(first)
    users, items = users_all[first], items_all[first]
    uniq_users, inv = np.unique(users, return_inverse=True)
    inv = inv.reshape(-1)
    sorted_items = _label_positions(labels, items)[np.argsort(inv, kind="stable")]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(inv, minlength=len(uniq_users)))]).astype(np.int64)
    negs = host.feed_neg_batch(indptr, sorted_items, item_sampler.prob_arr, item_sampler.alias_arr,
                               np.arange(len(labels), dtype=np.int64), negative_num,
                               seed=np.random.randint(2**31))
    return shuffle({
        DEFAULT_USER_COL: np.concatenate([users, np.repeat(uniq_users, negative_num)]),
        DEFAULT_ITEM_COL: np.concatenate([items, labels[negs.reshape(-1)]]),
        DEFAULT_RATING_COL: np.concatenate([np.ones(len(users)), np.zeros(negs.size)]),
    })


# -- split strategies ------------------------------------------------------------------


def _flagged(data):
    out = dict(data)
    out[DEFAULT_FLAG_COL] = np.full(n_rows(data), "train", dtype=object)
    return out


def _assign_tail_flags(flags, ordered_rows, test_rate):
    """The tail of an ordered row array is "test", the block before it
    "validate" (Python's slice rules at the edges, as in the JAX package)."""
    total = len(ordered_rows)
    validate_size = test_size = math.ceil(total * test_rate)
    train_size = total - test_size
    flags[ordered_rows[train_size:]] = "test"
    flags[ordered_rows[train_size - validate_size:train_size]] = "validate"


def _assign_basket_tail_flags(data, ordered_orders, test_rate):
    """Rows whose order lies in the tail of an ordered order-id array."""
    total = len(ordered_orders)
    validate_size = test_size = math.ceil(total * test_rate)
    train_size = total - test_size
    orders = np.asarray(data[DEFAULT_ORDER_COL])
    flags = data[DEFAULT_FLAG_COL]
    flags[np.isin(orders, ordered_orders[train_size:])] = "test"
    flags[np.isin(orders, ordered_orders[train_size - validate_size:train_size])] = "validate"


def random_split(data, test_rate=0.1, by_user=False):
    """The last ceil(n * test_rate) rows of a shuffled order are "test", the
    block before them "validate" (per user with ``by_user``)."""
    data = _flagged(data)
    if by_user:
        for _, rows in groups(data[DEFAULT_USER_COL]):
            _assign_tail_flags(data[DEFAULT_FLAG_COL], _shuffled(rows), test_rate)
    else:
        _assign_tail_flags(data[DEFAULT_FLAG_COL], _shuffled(np.arange(n_rows(data))), test_rate)
    return data


def random_basket_split(data, test_rate=0.1, by_user=False):
    """``random_split`` over baskets (orders)."""
    data = _flagged(data)
    orders = np.asarray(data[DEFAULT_ORDER_COL])
    if by_user:
        for _, rows in groups(data[DEFAULT_USER_COL]):
            _assign_basket_tail_flags(data, _shuffled(first_unique(orders[rows])), test_rate)
    else:
        _assign_basket_tail_flags(data, _shuffled(first_unique(orders)), test_rate)
    return data


def _user_heads(users, k):
    """``groupby(user).head(k)``: each user's first ``k`` rows."""
    rows = []
    for _, members in groups(users):
        rows.append(members[:k])
    return np.concatenate(rows) if rows else np.zeros(0, np.int64)


def leave_one_out(data, random=False):
    """Each user's newest row (first after a descending timestamp sort, or a
    shuffle with ``random``) is "test", the next "validate". Returns the
    frame in that order."""
    data = _flagged(data)
    data = shuffle(data) if random else take(data, _sort(data[DEFAULT_TIMESTAMP_COL], ascending=False))
    users = data[DEFAULT_USER_COL]
    data[DEFAULT_FLAG_COL][_user_heads(users, 2)] = "validate"
    data[DEFAULT_FLAG_COL][_user_heads(users, 1)] = "test"
    return data


def leave_one_basket(data, random=False):
    """Each user's last basket (by first appearance after an ascending
    timestamp sort, or a shuffle) is "test", the one before "validate"."""
    data = _flagged(data)
    data = shuffle(data) if random else take(data, _sort(data[DEFAULT_TIMESTAMP_COL]))
    users, orders = np.asarray(data[DEFAULT_USER_COL]), np.asarray(data[DEFAULT_ORDER_COL])
    u, _ = _codes(users)
    o, n_o = _codes(orders)
    key = u * n_o + o
    _, first = np.unique(key, return_index=True)
    first = np.sort(first)  # each (user, order) basket at its first row
    last, before_last = [], []
    for _, members in groups(users[first]):
        baskets = key[first[members]]
        last.append(baskets[-1])
        before_last.extend(baskets[-2:-1])
    data[DEFAULT_FLAG_COL][np.isin(key, last)] = "test"
    data[DEFAULT_FLAG_COL][np.isin(key, before_last)] = "validate"
    return data


def temporal_split(data, test_rate=0.1, by_user=False):
    """After an ascending timestamp sort, the newest ceil(n * test_rate)
    rows are "test", the block before them "validate" (per user, users in
    order of first appearance, with ``by_user``)."""
    data = _flagged(data)
    data = take(data, _sort(data[DEFAULT_TIMESTAMP_COL]))
    if by_user:
        for _, rows in groups(data[DEFAULT_USER_COL], sort=False):
            _assign_tail_flags(data[DEFAULT_FLAG_COL], rows, test_rate)
    else:
        _assign_tail_flags(data[DEFAULT_FLAG_COL], np.arange(n_rows(data)), test_rate)
    return data


def temporal_basket_split(data, test_rate=0.1, by_user=False):
    """``temporal_split`` over baskets in order of first appearance."""
    data = _flagged(data)
    data = take(data, _sort(data[DEFAULT_TIMESTAMP_COL]))
    orders = np.asarray(data[DEFAULT_ORDER_COL])
    if by_user:
        for _, rows in groups(data[DEFAULT_USER_COL], sort=False):
            _assign_basket_tail_flags(data, first_unique(orders[rows]), test_rate)
    else:
        _assign_basket_tail_flags(data, first_unique(orders), test_rate)
    return data


_SPLIT_FNS = {
    "random": lambda d, tr, rnd, bu: random_split(d, tr, bu),
    "random_basket": lambda d, tr, rnd, bu: random_basket_split(d, tr, bu),
    "leave_one_out": lambda d, tr, rnd, bu: leave_one_out(d, rnd),
    "leave_one_basket": lambda d, tr, rnd, bu: leave_one_basket(d, rnd),
    "temporal": lambda d, tr, rnd, bu: temporal_split(d, tr, bu),
    "temporal_basket": lambda d, tr, rnd, bu: temporal_basket_split(d, tr, bu),
}


# -- the split cache --------------------------------------------------------------------


def generate_parameterized_path(test_rate=0, random=False, n_negative=100, by_user=False):
    """The cache sub-directory name of a split's parameters."""
    path_str = "user_based" if by_user else "full"
    test_rate = round(test_rate * 100)
    if test_rate != 0:
        path_str += f"_test_rate_{test_rate}"
    if random:
        path_str += "_random"
    return path_str + f"_n_neg_{n_negative}"


def save_split_data(data, base_dir, data_split="leave_one_basket", parameterized_dir=None, suffix="train.npz"):
    """Save a split frame as <base_dir>/<split>/<param_dir>/<suffix>."""
    save_dataframe_as_npz(data, os.path.join(base_dir, data_split, parameterized_dir or "", suffix))


def load_split_data(path, n_test=10):
    """(train, valid, test) frames of a split directory. With ``n_test == 0``
    the raw (negative-free) ``valid.npz``/``test.npz``; otherwise lists of
    the first ``n_test`` negative-sampled copies ``valid_{i}``/``test_{i}``."""
    train = get_dataframe_from_npz(os.path.join(path, "train.npz"))
    if not n_test:
        return (train, get_dataframe_from_npz(os.path.join(path, "valid.npz")),
                get_dataframe_from_npz(os.path.join(path, "test.npz")))
    valid = [get_dataframe_from_npz(os.path.join(path, f"valid_{i}.npz")) for i in range(n_test)]
    test = [get_dataframe_from_npz(os.path.join(path, f"test_{i}.npz")) for i in range(n_test)]
    return train, valid, test


def _most_rows_a_user(frame):
    if not n_rows(frame):
        return None
    return int(np.bincount(_codes(frame[DEFAULT_USER_COL])[0]).max())


def split_data(data, split_type, test_rate, random=False, n_negative=100, save_dir=None, by_user=False, n_test=10,
               use_native=True):
    """Run a split strategy and, with ``save_dir``, write train/valid/test
    and ``n_test`` negative-sampled copies of valid and test. Returns the
    flagged frame (None for an unknown ``split_type``, as in the JAX
    package)."""
    if n_negative < 0 and n_test > 1:
        n_test = 1  # all-negatives mode has a single valid/test copy
    if split_type not in _SPLIT_FNS:
        print("[ERROR] wrong split_type.")
        return None
    data = _SPLIT_FNS[split_type](data, test_rate, random, by_user)
    if save_dir is None:
        return data
    flags = data[DEFAULT_FLAG_COL]
    tp_train, tp_validate, tp_test = (take(data, flags == flag) for flag in ("train", "validate", "test"))
    path = generate_parameterized_path(test_rate=test_rate, random=random, n_negative=n_negative, by_user=by_user)
    for frame, name in ((tp_train, "train.npz"), (tp_validate, "valid.npz"), (tp_test, "test.npz")):
        save_split_data(frame, save_dir, split_type, path, name)

    item_sampler = AliasTable(value_counts(data[DEFAULT_ITEM_COL]))
    n_items = len(np.unique(tp_train[DEFAULT_ITEM_COL]))
    valid_neg_max, test_neg_max = _most_rows_a_user(tp_validate), _most_rows_a_user(tp_test)
    if (valid_neg_max is not None and n_items - valid_neg_max < n_negative) or (
            test_neg_max is not None and n_items - test_neg_max < n_negative):
        raise RuntimeError(
            "This dataset do not have sufficient negative items for sampling! \n"
            f"valid_neg_max: {n_items - (valid_neg_max or 0)}, test_neg_max: {n_items - (test_neg_max or 0)}, "
            f"n_negative: {n_negative}\nPlease directly use valid.npz and test.npz."
        )
    for i in range(n_test):
        save_split_data(feed_neg_sample(tp_validate, n_negative, item_sampler, use_native), save_dir, split_type,
                        path, f"valid_{i}.npz")
        save_split_data(feed_neg_sample(tp_test, n_negative, item_sampler, use_native), save_dir, split_type,
                        path, f"test_{i}.npz")
    return data


def generate_random_data(n_interaction, user_id, item_id, seed=None):
    """A random implicit-feedback frame whose orders encode a basket index
    and the user (timestamps equal the orders, so they tie)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, user_id, size=n_interaction)
    orders = rng.integers(0, 10, size=n_interaction) * 100 + users
    items = rng.integers(0, item_id, size=n_interaction)
    return {
        DEFAULT_USER_COL: users,
        DEFAULT_ORDER_COL: orders,
        DEFAULT_TIMESTAMP_COL: orders.copy(),
        DEFAULT_ITEM_COL: items,
        DEFAULT_RATING_COL: np.ones(n_interaction, dtype=np.int64),
    }
