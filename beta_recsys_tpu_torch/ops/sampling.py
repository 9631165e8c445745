"""Negative sampling on the device: uniform draws, bounded rejection
against each user's train positives, and popularity draws from an alias
table.

Counterpart of ``uniform_negatives``, ``make_membership_test``,
``sample_negatives_rejection``, ``sample_negatives_rejection_bitmask`` and
``alias_negatives`` (with ``alias_sample``, the same draw) in
``beta_recsys_tpu/ops/sampling.py``. Every function is fixed-shape and draws
from an explicit ``torch.Generator`` on the ids' device, so nothing waits on
the host. Ids come back as int64, torch's index type (the JAX package returns
int32). Rejection runs a fixed ``n_rounds`` (4): each round redraws the
entries that still hit a positive, and an entry that hits one after the last
round keeps its draw, as in the JAX package. The two packages' generators
differ (threefry vs Philox), so the samplers agree in distribution, not draw
for draw.
"""

import numpy as np
import torch


def uniform_negatives(generator, shape, n_items, device):
    """Uniform item ids over the catalog (may hit a positive)."""
    return torch.randint(0, n_items, shape, generator=generator, device=device)


def make_membership_test(pos_indptr, pos_items_sorted, device):
    """fn(users, items) -> bool tensor, True where the item is one of the
    user's train positives, from per-user sorted positive lists in CSR form.

    The CSR pairs are lexsorted by (user, item), so the keys user * 2^32 +
    item are sorted as a whole: one ``torch.searchsorted`` over them is a
    binary search inside each user's segment."""
    pos_indptr = np.asarray(pos_indptr, dtype=np.int64)
    owners = np.repeat(np.arange(len(pos_indptr) - 1, dtype=np.int64), np.diff(pos_indptr))
    keys = torch.as_tensor((owners << 32) | np.asarray(pos_items_sorted, dtype=np.int64), device=device)

    def is_positive(users, items):
        query = (users.long() << 32) | items.long()
        if keys.numel() == 0:
            return torch.zeros_like(query, dtype=torch.bool)
        at = torch.searchsorted(keys, query).clamp_(max=keys.numel() - 1)
        return keys[at] == query

    return is_positive


def sample_negatives_rejection(generator, users, shape, n_items, is_positive, n_rounds=4):
    """Uniform negatives, redrawn up to ``n_rounds`` times where
    ``is_positive(users, items)`` holds. ``users`` must broadcast to ``shape``."""
    users_b = users.expand(shape)
    items = uniform_negatives(generator, shape, n_items, users.device)
    for _ in range(n_rounds):
        fresh = uniform_negatives(generator, shape, n_items, users.device)
        items = torch.where(is_positive(users_b, items), fresh, items)
    return items


def sample_negatives_rejection_bitmask(generator, users, shape, n_items, pos_mask, n_rounds=4):
    """``sample_negatives_rejection`` against a dense (n_users, n_items) bool
    positive mask on the device: one lookup per test, for small catalogs."""
    return sample_negatives_rejection(
        generator, users, shape, n_items, lambda u, i: pos_mask[u, i], n_rounds
    )


def alias_negatives(generator, shape, prob, alias):
    """Ids drawn by Walker's alias method on the device: one uniform slot
    and one uniform value a draw, the slot kept where the value lies below
    its threshold, else its alias. ``prob`` (float32) and ``alias`` (int64)
    are ``utils/alias_table.AliasTable``'s ``prob_arr`` and ``alias_arr``
    on the device."""
    idx = torch.randint(0, prob.shape[0], shape, generator=generator, device=prob.device)
    u = torch.rand(shape, generator=generator, device=prob.device)
    return torch.where(u < prob[idx], idx, alias[idx])
