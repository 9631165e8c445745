"""The port's offline split pipeline against the JAX package's, array for
array (keys, dtypes, shapes, values and row order): ``generate_random_data``
(tied timestamps), every split type on it and on the structured data, the
k-core on the host library and on numpy, ``feed_neg_sample`` on both paths,
and ``split_data``'s whole output directory under one ``np.random.seed``;
each package loads the other's directory. The host library's entry points
against their numpy plain versions."""

import os
from unittest import mock

import numpy as np
import pandas as pd
import pytest

from beta_recsys_tpu import native as jax_native
from beta_recsys_tpu.datasets import data_split as J
from beta_recsys_tpu.datasets.synthetic import generate_structured_data as jax_structured
from beta_recsys_tpu.utils.alias_table import AliasTable as JaxAliasTable
from beta_recsys_tpu_torch.datasets import data_split as P
from beta_recsys_tpu_torch.datasets import host
from beta_recsys_tpu_torch.datasets.synthetic import generate_structured_data
from beta_recsys_tpu_torch.utils.alias_table import AliasTable
from beta_recsys_tpu_torch.utils.constants import DEFAULT_FLAG_COL, DEFAULT_ITEM_COL, DEFAULT_ORDER_COL

SPLITS = ["random", "random_basket", "leave_one_out", "leave_one_basket", "temporal", "temporal_basket"]


def same_frame(want, got, what=""):
    """A pandas frame and a dict frame: the same columns, dtypes, values and
    row order (the flag column as strings)."""
    assert list(want.columns) == list(got), what
    for col in want.columns:
        a, b = want[col].to_numpy(), np.asarray(got[col])
        if col == DEFAULT_FLAG_COL:
            a, b = a.astype(str), b.astype(str)
        else:
            assert a.dtype == b.dtype, (what, col, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f"{what} {col}")


def same_dir(want_dir, got_dir):
    """Two split directories: the same files, each npz with the same keys in
    the same order and equal arrays."""
    files = sorted(os.listdir(want_dir))
    assert files == sorted(os.listdir(got_dir))
    for name in files:
        with np.load(os.path.join(want_dir, name)) as a, np.load(os.path.join(got_dir, name)) as b:
            assert list(a.keys()) == list(b.keys()), name
            for key in a:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, (name, key)
                np.testing.assert_array_equal(b[key], a[key], err_msg=f"{name} {key}")
    return files


@pytest.fixture(scope="module")
def random_frames():
    return J.generate_random_data(1500, 40, 70, seed=3), P.generate_random_data(1500, 40, 70, seed=3)


@pytest.fixture(scope="module")
def structured_frames():
    want = jax_structured(n_users=60, n_items=120, n_interactions=1500, seed=4)
    got = generate_structured_data(n_users=60, n_items=120, n_interactions=1500, seed=4)
    # Orders for the basket splits: each user's interactions in fours.
    for frame in (want, got):
        frame[DEFAULT_ORDER_COL] = np.asarray(frame["col_user"]) * 1000 + np.asarray(frame["col_timestamp"]) // 97
    return want, got


def test_generators_match_jax(random_frames, structured_frames):
    for want, got in (random_frames, structured_frames):
        same_frame(want, got)
    want, got = random_frames
    assert len(np.unique(got["col_timestamp"])) < len(got["col_timestamp"])  # ties to order


@pytest.mark.parametrize("by_user", [False, True])
@pytest.mark.parametrize("split_type", SPLITS)
@pytest.mark.parametrize("frames", ["random", "structured"])
def test_each_split_matches_jax(random_frames, structured_frames, frames, split_type, by_user):
    want, got = random_frames if frames == "random" else structured_frames
    np.random.seed(5)
    want = J._SPLIT_FNS[split_type](want.copy(), 0.15, False, by_user)
    np.random.seed(5)
    got = P._SPLIT_FNS[split_type](dict(got), 0.15, False, by_user)
    same_frame(want, got, split_type)
    assert set(got[DEFAULT_FLAG_COL]) == {"train", "validate", "test"}


@pytest.mark.parametrize("split_type", ["leave_one_out", "leave_one_basket"])
def test_random_leave_one_splits_match_jax(random_frames, split_type):
    want, got = random_frames
    np.random.seed(9)
    want = J._SPLIT_FNS[split_type](want.copy(), 0, True, False)
    np.random.seed(9)
    same_frame(want, P._SPLIT_FNS[split_type](dict(got), 0, True, False), split_type)


def _sparse_frames():
    """Zipf users and items, so a k-core drops rows over several rounds."""
    rng = np.random.default_rng(11)
    n = 3000
    users = rng.zipf(1.6, n) % 150
    items = rng.zipf(1.4, n) % 400
    orders = users * 10 + rng.integers(0, 4, n)
    frame = {"col_user": users, "col_order": orders, "col_timestamp": rng.integers(0, 500, n), "col_item": items,
             "col_rating": np.ones(n, np.int64)}
    return pd.DataFrame(frame), frame


@pytest.mark.parametrize("native", [True, False], ids=["host", "numpy"])
@pytest.mark.parametrize("thresholds", [(3, 5, 0), (2, 3, 3), (5, 8, 0)])
def test_kcore_matches_jax(native, thresholds):
    assert jax_native.available()
    want_in, got_in = _sparse_frames()
    min_u, min_i, min_o = thresholds
    if min_o:
        want = J.filter_user_item_order(want_in, min_u, min_i, min_o, use_native=native)
        got = P.filter_user_item_order(got_in, min_u, min_i, min_o, use_native=native)
    else:
        want = J.filter_user_item(want_in, min_u, min_i, use_native=native)
        got = P.filter_user_item(got_in, min_u, min_i, use_native=native)
    assert 0 < len(want) < len(want_in)  # the filter dropped rows and kept some
    same_frame(want, got, str(thresholds))


def test_an_emptied_kcore_raises():
    _, frame = _sparse_frames()
    with pytest.raises(RuntimeError, match="no interaction after filtering"):
        P.filter_user_item(frame, 10_000, 10_000)


def _eval_frame(explicit=False):
    rng = np.random.default_rng(2)
    n = 300
    frame = {"col_user": rng.integers(0, 30, n), "col_item": rng.integers(0, 60, n),
             "col_rating": rng.integers(1, 4, n).astype(np.float64) if explicit else np.ones(n)}
    return pd.DataFrame(frame), frame


@pytest.mark.parametrize("explicit", [False, True], ids=["implicit", "explicit"])
@pytest.mark.parametrize("native", [True, False], ids=["host", "numpy"])
@pytest.mark.parametrize("negative_num", [7, -1])
def test_feed_neg_sample_matches_jax(native, explicit, negative_num):
    want_in, got_in = _eval_frame(explicit)
    counts = P.value_counts(got_in[DEFAULT_ITEM_COL])
    assert list(counts) == list(want_in[DEFAULT_ITEM_COL].value_counts().to_dict())
    np.random.seed(3)
    want = J.feed_neg_sample(want_in, negative_num, JaxAliasTable(want_in[DEFAULT_ITEM_COL].value_counts().to_dict()),
                             use_native=native)
    np.random.seed(3)
    got = P.feed_neg_sample(got_in, negative_num, AliasTable(counts), use_native=native)
    same_frame(want, got)
    assert np.random.randint(2**31) == (np.random.seed(3), J.feed_neg_sample(
        want_in, negative_num, JaxAliasTable(want_in[DEFAULT_ITEM_COL].value_counts().to_dict()),
        use_native=native), np.random.randint(2**31))[-1]  # the same draws from the global state


@pytest.mark.parametrize("native", [True, False], ids=["host", "numpy"])
@pytest.mark.parametrize("split_type", SPLITS)
def test_split_data_directory_matches_jax_and_each_loads_the_other(tmp_path, random_frames, split_type, native):
    want_in, got_in = random_frames
    by_user = split_type in ("random", "temporal")
    with mock.patch.object(jax_native, "available", lambda: native):
        np.random.seed(7)
        J.split_data(want_in.copy(), split_type, 0.2, n_negative=6, save_dir=str(tmp_path / "jax"), n_test=2,
                     by_user=by_user)
    np.random.seed(7)
    P.split_data(dict(got_in), split_type, 0.2, n_negative=6, save_dir=str(tmp_path / "port"), n_test=2,
                 by_user=by_user, use_native=native)
    path = P.generate_parameterized_path(0.2, False, 6, by_user)
    want_dir, got_dir = (str(tmp_path / side / split_type / path) for side in ("jax", "port"))
    assert len(same_dir(want_dir, got_dir)) == 7
    # Each package reads the other's directory.
    ours = P.load_split_data(want_dir, n_test=2)
    theirs = J.load_split_data(got_dir, n_test=2)
    same_frame(theirs[0], ours[0])
    for want_copy, got_copy in zip(theirs[1] + theirs[2], ours[1] + ours[2]):
        same_frame(want_copy, got_copy)


def test_split_data_with_every_negative_writes_one_copy(tmp_path, random_frames):
    want_in, got_in = random_frames
    np.random.seed(1)
    J.split_data(want_in.copy(), "leave_one_out", 0, n_negative=-1, save_dir=str(tmp_path / "jax"), n_test=4)
    np.random.seed(1)
    P.split_data(dict(got_in), "leave_one_out", 0, n_negative=-1, save_dir=str(tmp_path / "port"), n_test=4)
    files = same_dir(*(str(tmp_path / side / "leave_one_out" / "full_n_neg_-1") for side in ("jax", "port")))
    assert "valid_0.npz" in files and "valid_1.npz" not in files


def test_unknown_split_and_too_few_negatives(tmp_path, random_frames):
    _, frame = random_frames
    assert P.split_data(dict(frame), "nope", 0.1) is None
    with pytest.raises(RuntimeError, match="sufficient negative"):
        P.split_data(dict(frame), "leave_one_out", 0, n_negative=1000, save_dir=str(tmp_path))


def test_parameterized_paths_match_jax():
    for args in [(0, False, 100, False), (0.2, True, 5, True), (0.1, False, -1, False)]:
        assert P.generate_parameterized_path(*args) == J.generate_parameterized_path(*args)


def test_host_library_against_its_plain_versions():
    """The host library builds here (g++), and each entry point agrees with
    its numpy version: alias tables equal the JAX binding's bit for bit and
    the Python table's to rounding (C++ scales each frequency in another
    order), draws in distribution, the k-cores' masks exactly."""
    lib, _ = host.build()
    assert lib.exists() and lib.parent.name == "torch_host"
    freqs = np.random.default_rng(0).integers(1, 50, 200).astype(np.float64)
    prob, alias = host.alias_build(freqs)
    for want, got in zip(jax_native.alias_build(freqs), (prob, alias)):
        np.testing.assert_array_equal(got, want)
    table = AliasTable(list(freqs))
    np.testing.assert_allclose(prob, table.prob_arr, rtol=1e-12)
    np.testing.assert_array_equal(alias, table.alias_arr)
    draws = np.bincount(host.alias_sample(prob, alias, 200_000, seed=1), minlength=200) / 200_000
    plain = np.bincount(host.alias_sample_numpy(prob, alias, 200_000, seed=1), minlength=200) / 200_000
    np.testing.assert_allclose(draws, freqs / freqs.sum(), atol=3e-3)
    np.testing.assert_allclose(plain, freqs / freqs.sum(), atol=3e-3)
    indptr, pos = np.array([0, 3, 5]), np.array([0, 1, 2, 7, 9])
    labels = np.arange(200)
    for fn in (host.feed_neg_batch, host.feed_neg_batch_numpy):
        negs = fn(indptr, pos, prob, alias, labels, 20, seed=2)
        assert negs.shape == (2, 20) and all(len(set(row)) == 20 for row in negs.tolist())
        assert not set(negs[0]) & {0, 1, 2} and not set(negs[1]) & {7, 9}
        with pytest.raises(host.InsufficientNegatives):
            fn(indptr, pos, prob, alias, labels, 199, seed=2)
    _, frame = _sparse_frames()
    u, n_u = P._codes(frame["col_user"])
    i, n_i = P._codes(frame["col_item"])
    np.testing.assert_array_equal(host.kcore_filter(u, i, n_u, n_i, 3, 4),
                                  host.kcore_filter_numpy(u, i, n_u, n_i, 3, 4))
    # The native k-core over distinct counts equals the JAX binding's.
    pairs, n_pairs = P._codes(u * n_i + i)
    np.testing.assert_array_equal(host.kcore_filter_distinct(u, i, pairs, None, n_u, n_i, n_pairs, 0, 3, 4),
                                  jax_native.kcore_filter_distinct(u, i, pairs, None, n_u, n_i, n_pairs, 0, 3, 4))


def test_a_failed_host_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host, "SOURCE", tmp_path / "broken.cc")
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host.build()
