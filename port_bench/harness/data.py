"""Interaction logs shaped like a MovieLens release, made on the device.

The recipe of ``chip_smoke.py``'s ``ml1m_shaped_split``, frozen here and
drawn with torch on the device so that MovieLens-20M's 20 million rows take
seconds: every user has ``min_per_user`` to ``max_per_user`` interactions, a
long-tailed (lognormal) count; each user's items are drawn without
repetition, weighted toward popular ones (log-popularity
``-exponent * log(rank + offset)`` plus Gumbel noise, top ``count`` per
user: a draw without replacement weighted by popularity); each user's
interactions are put in a random time order; leave-one-out: the newest is the
test positive, the one before it the validation positive.

A configuration's log is one draw, from its data block's ``seed``, as a
dataset is one file: a run's seed draws only what a run of training or
evaluation draws (batches, negatives, weights, dropout), so every seed gets
the same work in another order. The per-user counts are drawn on the host
(numpy, seed 0), the rest on the device; item ids are a permutation of
popularity ranks. Nothing dense of users x items is built whole; the draw
goes in blocks of users.
"""

from dataclasses import dataclass

import numpy as np
import torch

USER_BLOCK = 4096


def user_counts(shape):
    """The shape's per-user interaction counts (host int64), the same for
    every seed: lognormal weights, at least ``min_per_user``, at most
    ``max_per_user``, summing to ``n_interactions``."""
    n_users, total = shape["n_users"], shape["n_interactions"]
    lo, hi = shape["min_per_user"], shape["max_per_user"]
    rng = np.random.default_rng(0)
    weights = rng.lognormal(0.0, shape["count_sigma"], n_users)
    extra = np.floor(weights / weights.sum() * (total - lo * n_users)).astype(np.int64)
    counts = np.minimum(lo + extra, hi)
    while (short := total - counts.sum()) > 0:
        np.add.at(counts, rng.choice(np.nonzero(counts < hi)[0], short), 1)
        counts = np.minimum(counts, hi)
    return counts


@dataclass
class Split:
    n_users: int
    n_items: int
    users: torch.Tensor  # (n,) every interaction, grouped by user, oldest first
    items: torch.Tensor
    counts: torch.Tensor  # (n_users,)
    from_end: torch.Tensor  # (n,) 1 for a user's newest interaction

    def part(self, which):
        """(users, items) of "train" (all but the newest two of each user),
        "valid" (the second newest) or "test" (the newest)."""
        sel = {"train": self.from_end > 2, "valid": self.from_end == 2, "test": self.from_end == 1}[which]
        return self.users[sel], self.items[sel]

    def train_keys(self):
        """Sorted ``user * n_items + item`` of the train pairs: the positives
        a negative is rejected against."""
        users, items = self.part("train")
        return torch.sort(users * self.n_items + items).values

    def item_counts(self):
        """(n_items,) train interactions of each item."""
        return torch.bincount(self.part("train")[1], minlength=self.n_items)


def generator(seed, device, stream=0):
    """A torch generator on ``device`` for one of a run's independent streams
    (data, batches, weights, dropout), from a seed of any size."""
    return torch.Generator(device=device).manual_seed((int(seed) * 4 + stream) % (2**63 - 1))


def interactions(shape, device):
    """The ``Split`` of ``shape`` (a config's ``data`` block), drawn from its
    ``seed``."""
    g = generator(shape["seed"], device, 0)
    n_users, n_items = shape["n_users"], shape["n_items"]
    counts = torch.as_tensor(user_counts(shape), device=device)
    counts = counts[torch.randperm(n_users, generator=g, device=device)]
    rank = torch.arange(n_items, device=device, dtype=torch.float32)
    log_pop = -shape["popularity_exponent"] * torch.log(rank + shape["popularity_offset"])
    item_of_rank = torch.randperm(n_items, generator=g, device=device)
    users, items = [], []
    for lo in range(0, n_users, USER_BLOCK):
        hi = min(lo + USER_BLOCK, n_users)
        noise = torch.empty((hi - lo, n_items), device=device).exponential_(generator=g)
        order = torch.sort(log_pop[None, :] - torch.log(noise), dim=1, descending=True).indices
        take = torch.arange(n_items, device=device)[None, :] < counts[lo:hi, None]
        users.append(torch.arange(lo, hi, device=device)[:, None].expand(-1, n_items)[take])
        items.append(item_of_rank[order[take]])
    users, items = torch.cat(users), torch.cat(items)
    # A random time order within each user: sort by a random key, then
    # stably by user.
    order = torch.argsort(torch.rand(users.shape[0], generator=g, device=device))
    order = order[torch.sort(users[order], stable=True).indices]
    users, items = users[order], items[order]
    ends = torch.cumsum(counts, 0)
    from_end = ends[users] - torch.arange(users.shape[0], device=device)
    return Split(n_users, n_items, users, items, counts, from_end)


def is_positive(keys, users, items, n_items):
    """Whether each (user, item) pair is among the sorted ``keys``."""
    q = users * n_items + items
    at = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
    return keys[at] == q


def rejection_negatives(g, owners, n_items, keys):
    """One uniform item for each entry of ``owners`` that the owner has no
    train interaction with, redrawn until every draw passes."""
    neg = torch.randint(0, n_items, owners.shape, generator=g, device=owners.device)
    while True:
        bad = is_positive(keys, owners, neg, n_items)
        n_bad = int(bad.sum())
        if not n_bad:
            return neg
        neg[bad] = torch.randint(0, n_items, (n_bad,), generator=g, device=owners.device)


def sequences(split, maxlen):
    """SASRec's training arrays in the layout of the port's
    ``SequentialData.train_seq_arrays``: {"users": (n_users,), "seq",
    "pos": (n_users, maxlen)}, int64; ``seq`` holds each user's train items
    but the newest, ``pos`` each input's next item, the last ``maxlen`` of
    each, right-aligned and 0-padded on the left; items 1-indexed. Every
    user has at least two train items."""
    users, items = split.part("train")
    f = split.from_end[split.from_end > 2] - 2  # 1 for the newest train item
    n_train = split.counts - 2
    seq = torch.zeros((split.n_users, maxlen), dtype=torch.long, device=users.device)
    pos = torch.zeros_like(seq)
    inp = (f >= 2) & (f - 1 <= maxlen)
    seq[users[inp], maxlen - (f[inp] - 1)] = items[inp] + 1
    tgt = (f < n_train[users]) & (f <= maxlen)
    pos[users[tgt], maxlen - f[tgt]] = items[tgt] + 1
    return {"users": torch.arange(split.n_users, device=users.device), "seq": seq, "pos": pos}


def context(split, maxlen):
    """(n_users, maxlen) scoring context of the port's
    ``SequentialData.eval_context``: each user's last ``maxlen`` train
    items, 1-indexed, left-padded with 0."""
    users, items = split.part("train")
    f = split.from_end[split.from_end > 2] - 2
    keep = f <= maxlen
    ctx = torch.zeros((split.n_users, maxlen), dtype=torch.long, device=users.device)
    ctx[users[keep], maxlen - f[keep]] = items[keep] + 1
    return ctx
