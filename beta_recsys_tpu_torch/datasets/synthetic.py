"""A synthetic basket structure for the grocery models (numpy only).

Counterpart of ``add_synthetic_baskets`` in
``beta_recsys_tpu/datasets/synthetic.py``, on a frame of numpy columns
(``datasets/split_io.py``) in place of a pandas DataFrame.
"""

import numpy as np

from ..utils.constants import DEFAULT_ORDER_COL, DEFAULT_TIMESTAMP_COL, DEFAULT_USER_COL


def add_synthetic_baskets(frame, basket_size=5):
    """A copy of ``frame`` with an order column: each user's interactions,
    in timestamp order, go into consecutive baskets of ``basket_size``, and
    a basket's order id is ``user * 100_000 + rank // basket_size``.

    The timestamp order is pandas' ``sort_values``: numpy's default
    quicksort, which is not stable, over the column in the frame's row
    order, so tied timestamps rank as the JAX package ranks them."""
    users = np.asarray(frame[DEFAULT_USER_COL]).astype(np.int64)
    by_time = np.argsort(np.asarray(frame[DEFAULT_TIMESTAMP_COL]), kind="quicksort")
    # groupby(user).cumcount() over the sorted rows: each row's count of
    # earlier rows of its user in that order.
    sorted_users = users[by_time]
    by_user = np.argsort(sorted_users, kind="stable")
    grouped = sorted_users[by_user]
    starts = np.flatnonzero(np.r_[True, grouped[1:] != grouped[:-1]])
    run_start = np.repeat(starts, np.diff(np.r_[starts, len(grouped)]))
    count_sorted = np.empty(len(users), np.int64)
    count_sorted[by_user] = np.arange(len(users)) - run_start
    rank = np.empty(len(users), np.int64)
    rank[by_time] = count_sorted
    out = dict(frame)
    out[DEFAULT_ORDER_COL] = users * 100_000 + rank // basket_size
    return out
