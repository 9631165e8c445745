"""The port's negative samplers and their inputs (``pos_csr``,
``pos_bitmask``, ``train_arrays`` against the JAX package's): ids in range,
the bounded rejection replayed draw for draw, uniform frequencies over the
non-positives, the CSR membership test against a numpy set test, the
bitmask/CSR switch, and the residual-collision rate against the JAX
package's sampler (the two generators differ, so the samplers agree in
distribution)."""

import os

import jax
import numpy as np
import pytest
import torch

from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.ops.sampling import sample_negatives_rejection_bitmask as jax_rejection_bitmask
from beta_recsys_tpu_torch.core import train_engine
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.ops.sampling import (
    make_membership_test,
    sample_negatives_rejection,
    sample_negatives_rejection_bitmask,
    uniform_negatives,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
N_USERS, N_ITEMS, ROUNDS = 6, 40, 4


class _Positives:
    """Train positives of 6 users over 40 items: 0, 2, 8, 16, 24 and 32 of
    them, with ``pos_bitmask``/``pos_csr`` as ``BaseData`` gives them."""

    n_users, n_items = N_USERS, N_ITEMS

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.mask = np.zeros((N_USERS, N_ITEMS), dtype=bool)
        for u, d in enumerate((0, 2, 8, 16, 24, 32)):
            self.mask[u, rng.choice(N_ITEMS, d, replace=False)] = True

    def pos_bitmask(self):
        return self.mask

    def pos_csr(self):
        users, items = np.nonzero(self.mask)  # row-major: lexsorted
        indptr = np.concatenate([[0], np.cumsum(self.mask.sum(axis=1))]).astype(np.int32)
        return indptr, items.astype(np.int32)


def test_pos_csr_and_bitmask_match_jax_base_data():
    split = load_split_data(SPLIT, n_test=1)
    ours, ref = BaseData(split), JaxBaseData(jax_load_split_data(SPLIT, n_test=1))
    for got, want in zip(ours.pos_csr(), ref.pos_csr()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ours.pos_bitmask(), ref.pos_bitmask())
    for got, want in zip(ours.train_arrays(), ref.train_arrays()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_membership_test_equals_numpy_set_test():
    data = _Positives()
    indptr, items = data.pos_csr()
    is_positive = make_membership_test(indptr, items, device="cpu")
    users, cands = np.meshgrid(np.arange(N_USERS), np.arange(N_ITEMS), indexing="ij")
    got = is_positive(torch.from_numpy(users), torch.from_numpy(cands)).numpy()
    sets = [set(items[indptr[u]:indptr[u + 1]].tolist()) for u in range(N_USERS)]
    want = np.array([[i in sets[u] for i in range(N_ITEMS)] for u in range(N_USERS)])
    np.testing.assert_array_equal(got, want)
    empty = make_membership_test(np.zeros(3, np.int32), np.zeros(0, np.int32), device="cpu")
    assert not empty(torch.tensor([0, 1]), torch.tensor([3, 4])).any()


@pytest.mark.parametrize("mode", ["bitmask", "csr", "uniform"])
def test_ids_in_range_and_shape(mode):
    sampler = train_engine.make_negative_sampler(_Positives(), mode, device="cpu")
    users = torch.arange(N_USERS).repeat(50)
    neg = sampler(torch.Generator().manual_seed(1), users, (len(users),))
    assert neg.shape == users.shape and neg.dtype == torch.int64
    assert int(neg.min()) >= 0 and int(neg.max()) < N_ITEMS


def test_rejection_replays_draw_for_draw():
    """Each round redraws exactly the entries that still hit a positive, and
    an entry that hits one after the last round keeps its last draw."""
    data = _Positives()
    mask = torch.as_tensor(data.pos_bitmask())
    users = torch.arange(N_USERS).repeat(200)
    got = sample_negatives_rejection_bitmask(torch.Generator().manual_seed(7), users, users.shape, N_ITEMS, mask)
    gen = torch.Generator().manual_seed(7)
    draws = [uniform_negatives(gen, users.shape, N_ITEMS, "cpu") for _ in range(ROUNDS + 1)]
    want = draws[0]
    for fresh in draws[1:]:
        want = torch.where(mask[users, want], fresh, want)
    assert torch.equal(got, want)


def test_bitmask_and_csr_give_the_same_draws(monkeypatch):
    data = _Positives()
    users = torch.arange(N_USERS).repeat(100)
    auto_small = train_engine.make_negative_sampler(data, device="cpu")
    monkeypatch.setattr(train_engine, "_BITMASK_CELL_LIMIT", 0)  # "auto" now picks the CSR test
    auto_large = train_engine.make_negative_sampler(data, device="cpu")
    a = auto_small(torch.Generator().manual_seed(3), users, users.shape)
    b = auto_large(torch.Generator().manual_seed(3), users, users.shape)
    assert torch.equal(a, b)


def _collision_rates(draws_per_user, port_seed=0, jax_seed=0):
    data = _Positives()
    mask = data.pos_bitmask()
    users = np.repeat(np.arange(N_USERS), draws_per_user)
    port = sample_negatives_rejection(
        torch.Generator().manual_seed(port_seed), torch.from_numpy(users), users.shape, N_ITEMS,
        lambda u, i: torch.as_tensor(mask)[u, i],
    ).numpy()
    ref = np.asarray(jax_rejection_bitmask(
        jax.random.key(jax_seed), users, users.shape, N_ITEMS, jax.numpy.asarray(mask)
    ))
    rate = lambda items: np.bincount(users, weights=mask[users, items], minlength=N_USERS) / draws_per_user
    return rate(port), rate(ref), mask.sum(axis=1) / N_ITEMS, port, users, mask


def test_residual_collisions_within_the_four_round_bound_and_as_jax():
    """A draw survives as a collision only if all 1 + 4 draws hit a positive:
    rate (d/n)^5 for a user with d of n items positive. Both packages must
    sit within 5 binomial sigmas of it (n = 20,000 draws a user)."""
    n = 20_000
    port, ref, density, _, _, _ = _collision_rates(n)
    expected = density ** (ROUNDS + 1)
    sigma = np.sqrt(expected * (1 - expected) / n)
    assert port[0] == 0 and ref[0] == 0  # no positive: never a collision
    assert (np.abs(port - expected) <= 5 * sigma + 1e-12).all(), (port, expected)
    assert (np.abs(ref - expected) <= 5 * sigma + 1e-12).all(), (ref, expected)


def test_non_positive_frequencies_are_uniform():
    """Among a user's non-positive items every one is equally likely: each
    count lies within 5 sigma of the mean (20,000 draws a user)."""
    _, _, _, items, users, mask = _collision_rates(20_000)
    for u in range(N_USERS):
        mine = items[users == u]
        free = np.nonzero(~mask[u])[0]
        counts = np.bincount(mine[~mask[u, mine]], minlength=N_ITEMS)[free]
        mean = counts.mean()
        assert (np.abs(counts - mean) <= 5 * np.sqrt(mean)).all(), (u, counts)
