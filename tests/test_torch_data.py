"""The port's split reader and data layer equal the JAX package's exactly."""

import os

import numpy as np
import pandas as pd
import pytest

from beta_recsys_tpu.data.sequential_data import SequentialData as JaxSequentialData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu_torch.data.sequential_data import SequentialData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
COLUMNS = (DEFAULT_USER_COL, DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_TIMESTAMP_COL)


@pytest.fixture(scope="module")
def both():
    ours = SequentialData(load_split_data(SPLIT, n_test=1))
    ref = JaxSequentialData(jax_load_split_data(SPLIT, n_test=1))
    return ours, ref


def assert_frame_equal(frame, df):
    assert set(frame) == set(df.columns)
    for col in frame:
        np.testing.assert_array_equal(frame[col], df[col].to_numpy(), err_msg=col)
        assert frame[col].dtype == df[col].dtype, col


@pytest.mark.parametrize("n_test", [0, 1])
def test_split_reader_equals_reference(n_test):
    ours = load_split_data(SPLIT, n_test=n_test)
    ref = jax_load_split_data(SPLIT, n_test=n_test)
    assert_frame_equal(ours[0], ref[0])
    for part_ours, part_ref in zip(ours[1:], ref[1:]):
        if n_test:
            assert len(part_ours) == len(part_ref) == n_test
            for frame, df in zip(part_ours, part_ref):
                assert_frame_equal(frame, df)
        else:
            assert_frame_equal(part_ours, part_ref)


def test_reindexed_frames_equal_reference(both):
    ours, ref = both
    assert (ours.n_users, ours.n_items) == (ref.n_users, ref.n_items)
    np.testing.assert_array_equal(ours.user_pool, ref.user_pool)
    np.testing.assert_array_equal(ours.item_pool, ref.item_pool)
    for frame, df in [(ours.train, ref.train), (ours.valid[0], ref.valid[0]), (ours.test[0], ref.test[0])]:
        for col in COLUMNS:
            np.testing.assert_array_equal(frame[col], df[col].to_numpy(), err_msg=col)


@pytest.mark.parametrize("extended", [False, True], ids=["train", "train+valid"])
@pytest.mark.parametrize("maxlen", [5, 100])
def test_eval_context_equals_reference(both, extended, maxlen):
    ours, ref = both
    got = ours.eval_context(maxlen, extra_df=ours.valid[0] if extended else None)
    want = ref.eval_context(maxlen, extra_df=ref.valid[0] if extended else None)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_train_sequences_equal_reference(both):
    ours, ref = both
    for got, want in zip(ours.get_train_seq(), ref.get_train_seq()):
        np.testing.assert_array_equal(got, want)


def test_eval_candidates_and_csr_equal_reference(both):
    ours, ref = both
    for frame, df in [(ours.valid[0], ref.valid[0]), (ours.test[0], ref.test[0])]:
        got, want = ours.eval_candidates(frame), ref.eval_candidates(df)
        for name in got._fields:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    got, want = ours.user_item_csr(), ref.user_item_csr()
    assert got.shape == want.shape and (got != want).nnz == 0


def _unsorted_split(seed=3):
    """Raw ids in no sorted order, ratings on a 0-5 scale, duplicate
    timestamps, and valid/test rows naming users and items unseen in train."""
    rng = np.random.default_rng(seed)
    users = rng.permutation(np.arange(100, 140))[rng.integers(0, 40, 400)]
    items = rng.permutation(np.arange(5000, 5090))[rng.integers(0, 90, 400)]
    train = {
        DEFAULT_USER_COL: users, DEFAULT_ITEM_COL: items,
        DEFAULT_RATING_COL: rng.integers(0, 6, 400).astype(np.float32),
        DEFAULT_TIMESTAMP_COL: rng.integers(0, 50, 400),
    }

    def evalframe(n):
        return {
            DEFAULT_USER_COL: np.concatenate([users[rng.integers(0, 400, n)], [999]]),
            DEFAULT_ITEM_COL: np.concatenate([items[rng.integers(0, 400, n)], [items[0]]]),
            DEFAULT_RATING_COL: np.concatenate([(rng.random(n) < 0.3).astype(np.float32), [1.0]]),
            DEFAULT_TIMESTAMP_COL: np.zeros(n + 1, np.int64),
        }

    return train, [evalframe(120)], [evalframe(120)]


def test_first_appearance_reindexing_on_unsorted_ids():
    split = _unsorted_split()
    ours = SequentialData(split, bin_thld=2.0)
    ref = JaxSequentialData(
        tuple(pd.DataFrame(p) if isinstance(p, dict) else [pd.DataFrame(f) for f in p] for p in split),
        bin_thld=2.0,
    )
    np.testing.assert_array_equal(ours.user_pool, ref.user_pool)
    assert not np.all(np.diff(ours.user_pool) > 0)  # first appearance, not sorted
    for frame, df in [(ours.train, ref.train), (ours.valid[0], ref.valid[0]), (ours.test[0], ref.test[0])]:
        for col in COLUMNS:
            np.testing.assert_array_equal(frame[col], df[col].to_numpy(), err_msg=col)
    for maxlen in (3, 30):
        np.testing.assert_array_equal(ours.eval_context(maxlen), ref.eval_context(maxlen))
        np.testing.assert_array_equal(
            ours.eval_context(maxlen, extra_df=ours.valid[0]),
            ref.eval_context(maxlen, extra_df=ref.valid[0]),
        )
    got, want = ours.eval_candidates(ours.test[0]), ref.eval_candidates(ref.test[0])
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (ours.user_item_csr() != ref.user_item_csr()).nnz == 0
    # the caller's frames are untouched
    np.testing.assert_array_equal(split[0][DEFAULT_USER_COL], _unsorted_split()[0][DEFAULT_USER_COL])
