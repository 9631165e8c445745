"""Synthetic dataset adapters and a synthetic basket structure (numpy only).

Counterpart of ``beta_recsys_tpu/datasets/synthetic.py`` on frames of numpy
columns (``utils/common.py``): ``generate_structured_data`` (a power-law,
block-structured world with planted group affinity and Markov group
persistence along each user's timeline, the parity harness's dataset),
``Synthetic`` (``generate_random_data``'s uniform noise) and
``SyntheticStructured``, whose interaction npz and splits equal the JAX
package's for the same seed, and ``add_synthetic_baskets``.
"""

import numpy as np

from ..utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_ORDER_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)
from .data_split import generate_random_data
from .dataset_base import DatasetBase


def generate_structured_data(n_users=943, n_items=1682, n_interactions=100_000, n_groups=8, zipf_user=1.1,
                             zipf_item=1.05, affinity=0.75, markov=0.6, min_per_user=5, seed=2020):
    """Power-law, block-structured implicit interactions (ml-100k shaped):
    zipf item popularity with ranks dealt round-robin into ``n_groups``
    groups; zipf user activity floored at ``min_per_user`` and capped, the
    clipped mass dealt back once; each user walks a Markov chain over groups
    (stay w.p. ``markov``, else home w.p. ``affinity``, else a uniform jump)
    and takes items of the visited group by popularity without repeats
    (Gumbel top-k); timestamps interleave users, each user's steps in
    order."""
    rng = np.random.default_rng(seed)
    item_rank = rng.permutation(n_items)
    pop = 1.0 / (item_rank + 1.0) ** zipf_item
    group_of_item = item_rank % n_groups
    log_pop = np.log(pop)

    user_rank = rng.permutation(n_users)
    act = 1.0 / (user_rank + 10.0) ** zipf_user
    cap = max(n_items // 4, min_per_user + 1)
    counts = np.clip(np.round(act / act.sum() * n_interactions).astype(int), min_per_user, cap)
    deficit = n_interactions - counts.sum()
    if deficit > 0:
        room = cap - counts
        counts += np.minimum(np.round(room / max(room.sum(), 1) * deficit).astype(int), room)
    home = rng.integers(0, n_groups, n_users)

    users_out, items_out, steps_out = [], [], []
    for u in range(n_users):
        c = int(counts[u])
        stay = rng.random(c) < markov
        to_home = rng.random(c) < affinity
        jumps = rng.integers(0, n_groups, c)
        g = np.empty(c, dtype=np.int64)
        cur = home[u]
        for t in range(c):
            if not stay[t]:
                cur = home[u] if to_home[t] else jumps[t]
            g[t] = cur
        keys = log_pop + rng.gumbel(size=n_items)
        pref_order = np.argsort(-keys)
        pref_groups = group_of_item[pref_order]
        per_group = [pref_order[pref_groups == gg] for gg in range(n_groups)]
        taken = np.zeros(n_groups, dtype=np.int64)
        its = np.empty(c, dtype=np.int64)
        for t in range(c):
            gg = g[t]
            if taken[gg] >= len(per_group[gg]):  # group exhausted: the least-used group
                gg = int(np.argmin(taken / np.maximum([len(p) for p in per_group], 1)))
                g[t] = gg
            its[t] = per_group[gg][taken[gg]]
            taken[gg] += 1
        users_out.append(np.full(c, u, dtype=np.int64))
        items_out.append(its)
        steps_out.append(np.arange(c, dtype=np.int64))

    users, items, steps = np.concatenate(users_out), np.concatenate(items_out), np.concatenate(steps_out)
    order = np.lexsort((rng.random(len(users)), steps))  # by step, a random tiebreak
    return {
        DEFAULT_USER_COL: users[order],
        DEFAULT_ITEM_COL: items[order],
        DEFAULT_RATING_COL: np.ones(len(users), dtype=np.float32),
        DEFAULT_TIMESTAMP_COL: np.arange(len(users), dtype=np.int64),
    }


class Synthetic(DatasetBase):
    """Random implicit-feedback interactions with basket structure."""

    def __init__(self, dataset_name="synthetic", min_u_c=0, min_i_c=0, root_dir=None, n_interactions=20_000,
                 n_users=300, n_items=400, seed=42):
        super().__init__(dataset_name=dataset_name, min_u_c=min_u_c, min_i_c=min_i_c, root_dir=root_dir,
                         tips="synthetic dataset generates itself; no download needed")
        self.n_interactions, self.n_users, self.n_items, self.seed = n_interactions, n_users, n_items, seed

    def download(self):
        pass  # nothing to download

    def preprocess(self):
        data = generate_random_data(self.n_interactions, self.n_users, self.n_items, seed=self.seed)
        self.save_dataframe_as_npz(data, self.interaction_file())


class SyntheticStructured(DatasetBase):
    """Power-law block-structured interactions (the parity harness's dataset)."""

    def __init__(self, dataset_name="synthetic_structured", min_u_c=0, min_i_c=0, root_dir=None,
                 n_interactions=100_000, n_users=943, n_items=1682, seed=2020, **gen_kwargs):
        super().__init__(dataset_name=dataset_name, min_u_c=min_u_c, min_i_c=min_i_c, root_dir=root_dir,
                         tips="synthetic dataset generates itself; no download needed")
        self.n_interactions, self.n_users, self.n_items, self.seed = n_interactions, n_users, n_items, seed
        self.gen_kwargs = gen_kwargs

    def download(self):
        pass  # nothing to download

    def preprocess(self):
        data = generate_structured_data(n_users=self.n_users, n_items=self.n_items,
                                        n_interactions=self.n_interactions, seed=self.seed, **self.gen_kwargs)
        self.save_dataframe_as_npz(data, self.interaction_file())


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
