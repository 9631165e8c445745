"""The grocery models' host layers in the port against the JAX package:
``add_synthetic_baskets``, ``AliasTable`` (its tables and its host draw),
both ``Sampler`` draws and their CSV cache, ``GroceryData.sample_triples``
and ``user_item_features`` are bit-equal on the structured split and on a
small frame with tied timestamps; ``alias_negatives`` draws on the device
in distribution (a chi-square against the table's probabilities)."""

import os

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import stats

from beta_recsys_tpu.data.grocery_data import GroceryData as JaxGroceryData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.datasets.synthetic import add_synthetic_baskets as jax_add_synthetic_baskets
from beta_recsys_tpu.utils.alias_table import AliasTable as JaxAliasTable
from beta_recsys_tpu.utils.triple_sampler import Sampler as JaxSampler
from beta_recsys_tpu_torch.data.grocery_data import GroceryData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.datasets.synthetic import add_synthetic_baskets
from beta_recsys_tpu_torch.ops.sampling import alias_negatives
from beta_recsys_tpu_torch.utils.alias_table import AliasTable
from beta_recsys_tpu_torch.utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_ORDER_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)
from beta_recsys_tpu_torch.utils.triple_sampler import Sampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
COLUMNS = {"users": "UID", "item1": "PID1", "item2": "PID2", "t": "T"}


def tied_frame(n_users=30, n_items=40, n_rows=600, seed=0):
    """Interactions whose timestamps take 7 values (ties everywhere), rows
    in random order."""
    rng = np.random.default_rng(seed)
    return {DEFAULT_USER_COL: rng.integers(0, n_users, n_rows), DEFAULT_ITEM_COL: rng.integers(0, n_items, n_rows),
            DEFAULT_RATING_COL: np.ones(n_rows, np.float32),
            DEFAULT_TIMESTAMP_COL: rng.integers(0, 7, n_rows).astype(np.int64)}


@pytest.fixture(scope="module")
def splits():
    """{name: (port split with baskets, JAX split with baskets)}: the
    structured split and a tied frame (its train part also evaluated)."""
    train, valid, test = load_split_data(SPLIT, n_test=1)
    jtrain, jvalid, jtest = jax_load_split_data(SPLIT, n_test=1)
    tied = tied_frame()
    return {
        "structured": ((add_synthetic_baskets(train), valid, test), (jax_add_synthetic_baskets(jtrain), jvalid, jtest)),
        "tied": ((add_synthetic_baskets(tied, 3), tied, tied),
                 (jax_add_synthetic_baskets(pd.DataFrame(tied), 3), pd.DataFrame(tied), pd.DataFrame(tied))),
    }


@pytest.mark.parametrize("basket_size", [5, 3, 1])
@pytest.mark.parametrize("which", ["structured", "tied"])
def test_synthetic_baskets_equal_jax(which, basket_size):
    frame = load_split_data(SPLIT, n_test=1)[0] if which == "structured" else tied_frame()
    got = add_synthetic_baskets(frame, basket_size)
    want = jax_add_synthetic_baskets(pd.DataFrame(frame), basket_size)
    assert got[DEFAULT_ORDER_COL].dtype == np.int64
    assert np.array_equal(got[DEFAULT_ORDER_COL], want[DEFAULT_ORDER_COL].to_numpy())
    assert DEFAULT_ORDER_COL not in frame  # a copy
    # Each user's baskets hold basket_size interactions but the last.
    users, counts = np.unique(got[DEFAULT_ORDER_COL], return_counts=True)
    assert counts.max() == basket_size


FREQS = {
    "popularity": list(np.bincount(np.random.default_rng(1).zipf(1.5, 500) % 97, minlength=97).astype(float)),
    "ties_and_zeros": [0.0, 3.0, 3.0, 1.0, 0.0, 7.0, 3.0, 1.0, 1.0, 2.0],
    "uniform": [5.0] * 13,
    "dict": {"a": 2.0, "b": 0.5, "c": 9.0, "d": 0.5},
}


@pytest.mark.parametrize("name", list(FREQS))
def test_alias_table_equals_jax(name):
    freq = FREQS[name]
    got, want = AliasTable(freq), JaxAliasTable(freq)
    assert got.prob_arr.dtype == want.prob_arr.dtype == np.float64
    assert np.array_equal(got.prob_arr, want.prob_arr) and np.array_equal(got.alias_arr, want.alias_arr)
    assert got.index2Label == want.index2Label and got.vocab_size == want.vocab_size
    # The host draw from numpy's global state equals JAX's, with and without repeats.
    for count, obj_num, no_repeat in ((5, 1, False), (20, 3, False), (3, 2, True)):
        np.random.seed(7)
        expected = want.sample(count, obj_num, no_repeat)
        np.random.seed(7)
        assert got.sample(count, obj_num, no_repeat) == expected


@pytest.mark.parametrize("time_step", [0, 2, 3, 4])
@pytest.mark.parametrize("which", ["structured", "tied"])
def test_sampler_draws_equal_jax(splits, which, time_step):
    """Both draws (``sample`` and ``sample_by_time``) with the same seed give
    the JAX package's triples and time buckets bit for bit."""
    ours, ref = splits[which]
    data, jax_data = GroceryData(ours), JaxGroceryData(ref)
    got = Sampler(data.train, "unused", 3000, dump=False, seed=11).sample_by_time(time_step)
    want = JaxSampler(jax_data.train, "unused", 3000, dump=False, seed=11).sample_by_time(time_step)
    assert list(got) == list(want.columns)
    for col in got:
        assert np.array_equal(got[col], want[col].to_numpy()), col
    assert set(np.unique(got["UID"])) <= set(range(data.n_users))


def test_triples_come_from_one_basket(splits):
    """Every triple's two items lie in one basket of its user."""
    ours, _ = splits["tied"]
    data = GroceryData(ours)
    triples = Sampler(data.train, "unused", 500, dump=False, seed=3).sample()
    baskets = {}
    for u, o, i in zip(data.train[DEFAULT_USER_COL], data.train[DEFAULT_ORDER_COL], data.train[DEFAULT_ITEM_COL]):
        baskets.setdefault((u, o), set()).add(i)
    by_user = {}
    for (u, _), items in baskets.items():
        by_user.setdefault(u, []).append(items)
    for u, i, j in zip(triples["UID"], triples["PID1"], triples["PID2"]):
        assert any(i in items and j in items for items in by_user[u])


@pytest.mark.parametrize("time_step", [0, 4])
def test_csv_cache_both_ways(splits, tmp_path, time_step):
    """The port's dump reads back through pandas as the JAX package reads
    its own, and the port reads the JAX package's dump; ``load_save``
    returns the cached triples."""
    ours, ref = splits["tied"]
    data, jax_data = GroceryData(ours), JaxGroceryData(ref)
    mine, theirs = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    got = Sampler(data.train, mine, 200, dump=True, seed=5).sample_by_time(time_step)
    JaxSampler(jax_data.train, theirs, 200, dump=True, seed=5).sample_by_time(time_step)
    read_mine = JaxSampler(None, mine, 200).load_triples_from_file(mine)
    read_theirs = Sampler(None, theirs, 200).load_triples_from_file(theirs)
    assert list(read_mine.columns) == list(read_theirs) == list(got)
    for col in got:
        assert np.array_equal(read_mine[col].to_numpy(), got[col])
        assert np.array_equal(read_theirs[col], got[col])
    cached = Sampler(None, mine, 200, load_save=True, seed=99).sample_by_time(time_step)
    assert all(np.array_equal(cached[col], got[col]) for col in got)


@pytest.mark.parametrize("time_step", [0, 4])
def test_sample_triples_equal_jax(splits, tmp_path, time_step):
    ours, ref = splits["structured"]
    got = GroceryData(ours).sample_triples(5000, time_step=time_step, seed=2)
    want = JaxGroceryData(ref).sample_triples(5000, time_step=time_step, seed=2)
    assert list(got) == list(want) == list(COLUMNS)[: 3 + (time_step > 0)]
    for key in got:
        assert got[key].dtype == want[key].dtype == np.int32
        assert np.array_equal(got[key], want[key]), key
    dumped = GroceryData(ours).sample_triples(50, time_step=time_step, sample_dir=str(tmp_path), dump=True, seed=2)
    assert os.path.exists(tmp_path / f"triple_50_{time_step}.csv")
    again = GroceryData(ours).sample_triples(50, time_step=time_step, sample_dir=str(tmp_path), load_save=True)
    assert all(np.array_equal(dumped[key], again[key]) for key in dumped)


@pytest.mark.parametrize("fea_type", ["random", "one_hot"])
def test_user_item_features_equal_jax(splits, fea_type):
    ours, ref = splits["tied"]
    data, jax_data = GroceryData(ours), JaxGroceryData(ref)
    dic = None
    if fea_type != "random":
        rng = np.random.default_rng(4)
        dic = {"b": rng.random((data.n_items, 3)), "a": np.eye(data.n_items)}
    for seed in (0, 3):
        got = data.user_item_features(fea_type, emb_dim=16, item_fea_dic=dic, seed=seed)
        want = jax_data.user_item_features(fea_type, emb_dim=16, item_fea_dic=dic, seed=seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)
    assert got[1].shape == (data.n_items, 16 if dic is None else data.n_items + 3)


@pytest.mark.parametrize("name", ["popularity", "ties_and_zeros"])
def test_alias_negatives_follow_the_table(name):
    """Draws on the device follow the distribution that ``prob`` and
    ``alias`` encode, which is the frequencies': a chi-square over 200,000
    draws (the seed fixes the draws, so the test is deterministic)."""
    freq = np.asarray(FREQS[name], dtype=np.float64)
    table = AliasTable(list(freq))
    n = len(freq)
    encoded = np.minimum(table.prob_arr, 1.0)
    np.add.at(encoded, table.alias_arr, 1.0 - np.minimum(table.prob_arr, 1.0))
    np.testing.assert_allclose(encoded / n, freq / freq.sum(), atol=1e-12)
    prob = torch.as_tensor(table.prob_arr, dtype=torch.float32)
    alias = torch.as_tensor(table.alias_arr, dtype=torch.long)
    draws = alias_negatives(torch.Generator().manual_seed(0), (400, 500), prob, alias)
    assert draws.shape == (400, 500) and draws.dtype == torch.long
    counts = np.bincount(draws.numpy().ravel(), minlength=n)
    expected = draws.numel() * freq / freq.sum()
    assert not counts[expected == 0].any()
    seen = expected > 0
    assert stats.chisquare(counts[seen], expected[seen]).pvalue > 1e-3
