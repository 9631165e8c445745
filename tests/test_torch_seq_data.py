"""The port's sequence host arrays equal the JAX package's bit for bit:
``prefix_target_arrays``, ``_user_times``, ``_clipped_interval_matrix``,
``tisasrec_arrays`` and ``tisasrec_eval_context`` (with and without the
validation extension), on the structured split and on a hand-made frame
with equal timestamps, a one-item user, a user whose scaled times round
half to even and two validation positives for one user."""

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


def _frame(rows):
    users, items, stamps = (np.array(c, dtype=np.int64) for c in zip(*rows))
    return {DEFAULT_USER_COL: users, DEFAULT_ITEM_COL: items,
            DEFAULT_RATING_COL: np.ones(len(users), np.float32), DEFAULT_TIMESTAMP_COL: stamps}


def _hand_made():
    """Raw ids, rows out of time order:
    user 10: equal stamps (every gap 0: scale 1);
    user 11: one item (no training row, times [1]);
    user 12: stamps 0, 2, 5, 9 (scale 2: 2.5 rounds to 2, 4.5 to 4);
    user 13: 9 items a day apart with two equal (the context truncates);
    user 14: two items, both validation positives appended after them."""
    rows = [(10, 1, 500), (12, 2, 9), (10, 2, 500), (13, 3, 86_400 * 3), (12, 1, 0), (11, 4, 77),
            (10, 3, 500), (12, 3, 2), (12, 4, 5), (14, 5, 1000), (14, 6, 1003)]
    rows += [(13, 5 + i, 86_400 * i) for i in (0, 1, 2, 4, 5, 6, 7)] + [(13, 4, 86_400 * 7)]
    train = _frame(rows)
    valid = _frame([(12, 6, 0), (14, 1, 0), (14, 2, 0), (10, 6, 0), (99, 1, 0)])
    valid[DEFAULT_RATING_COL][3] = 0.0  # a negative: not appended
    test = _frame([(13, 1, 0)])
    return train, [valid], [test]


def _both(split_dataset):
    pandas = tuple(pd.DataFrame(p) if isinstance(p, dict) else [pd.DataFrame(f) for f in p] for p in split_dataset)
    return SequentialData(split_dataset), JaxSequentialData(pandas)


@pytest.fixture(scope="module", params=["structured", "hand-made"])
def both(request):
    if request.param == "structured":
        return SequentialData(load_split_data(SPLIT, n_test=1)), JaxSequentialData(jax_load_split_data(SPLIT, n_test=1))
    return _both(_hand_made())


def _equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("maxlen", [1, 3, 19])
def test_prefix_target_arrays_equal_jax(both, maxlen):
    ours, ref = both
    got, want = ours.prefix_target_arrays(maxlen), ref.prefix_target_arrays(maxlen)
    assert set(got) == set(want) == {"seq", "target"}
    for key in want:
        _equal(got[key], want[key], key)


def test_user_times_equal_jax(both):
    ours, ref = both
    got, want = ours._user_times(), ref._user_times()
    assert len(got) == len(want) == ours.n_users
    for u, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"user {u}")


@pytest.mark.parametrize("span", [1, 4, 256])
def test_clipped_interval_matrix_equals_jax(span):
    rng = np.random.default_rng(span)
    for row in (rng.integers(0, 400, 7), np.zeros(3, np.int64), np.array([5])):
        _equal(SequentialData._clipped_interval_matrix(row, span),
               JaxSequentialData._clipped_interval_matrix(row, span))
    rows = rng.integers(0, 400, (5, 6))  # the port's also takes a batch of rows
    _equal(SequentialData._clipped_interval_matrix(rows, span),
           np.stack([JaxSequentialData._clipped_interval_matrix(r, span) for r in rows]))


@pytest.mark.parametrize("maxlen,span", [(3, 2), (8, 256), (50, 256)])
def test_tisasrec_arrays_equal_jax(both, maxlen, span):
    ours, ref = both
    got, want = ours.tisasrec_arrays(maxlen, span), ref.tisasrec_arrays(maxlen, span)
    assert set(got) == set(want) == {"users", "seq", "pos", "time_matrix"}
    for key in want:
        _equal(got[key], want[key], key)


@pytest.mark.parametrize("extended", [False, True], ids=["train", "train+valid"])
@pytest.mark.parametrize("maxlen,span", [(3, 2), (8, 256), (50, 256)])
def test_tisasrec_eval_context_equals_jax(both, extended, maxlen, span):
    ours, ref = both
    got = ours.tisasrec_eval_context(maxlen, span, extra_df=ours.valid[0] if extended else None)
    want = ref.tisasrec_eval_context(maxlen, span, extra_df=ref.valid[0] if extended else None)
    for g, w, what in zip(got, want, ("ctx", "ctx_time")):
        _equal(g, w, what)
    # Position p of the context is row and column p of the matrix: the
    # eval context's items are eval_context's.
    _equal(got[0], ours.eval_context(maxlen, extra_df=ours.valid[0] if extended else None))


def test_the_hand_made_frame_holds_its_cases():
    ours, _ = _both(_hand_made())
    times = ours._user_times()
    by_raw = {int(raw): u for u, raw in enumerate(ours.user_pool)}
    assert list(times[by_raw[10]]) == [1, 1, 1]
    assert list(times[by_raw[11]]) == [1]
    assert list(times[by_raw[12]]) == [1, 2, 3, 5]  # (0, 2, 5, 9) / 2: 2.5 -> 2, 4.5 -> 4, then + 1
    ctx, mats = ours.tisasrec_eval_context(4, 256, extra_df=ours.valid[0])
    assert list(mats[by_raw[14], -1]) == [3, 2, 1, 0]  # scaled times 1, 2, then 3 and 4 appended
