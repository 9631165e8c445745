"""The port's last host modules against the JAX package's: ``Auxiliary``,
the four ``instance_*_loader``s and ``UnigramTable`` bit for bit under the
same numpy generators, and ``utils/evaluation.py``'s golden metrics to 1e-12
on frames with ties, users without a relevant item and k beyond a user's
list."""

import numpy as np
import pandas as pd
import pytest

from beta_recsys_tpu.data import auxiliary_data as jax_aux
from beta_recsys_tpu.data import data_loaders as jax_loaders
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.utils import evaluation as jax_eval
from beta_recsys_tpu.utils.unigram_table import UnigramTable as JaxUnigramTable
from beta_recsys_tpu_torch.data import auxiliary_data, data_loaders
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.utils import evaluation
from beta_recsys_tpu_torch.utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_PREDICTION_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)
from beta_recsys_tpu_torch.utils.unigram_table import UnigramTable

U, I, R, P = DEFAULT_USER_COL, DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_PREDICTION_COL


# -- Auxiliary -----------------------------------------------------------------------

def _fea_loader(fea_type):
    rng = np.random.default_rng(len(fea_type))
    dim = {"one_hot": 3, "word2vec": 5, "bert": 2, "cate": 4}[fea_type]
    return {raw: rng.normal(size=dim).astype(np.float32) for raw in (10, 12, 15, 99)}


@pytest.mark.parametrize("fea_type", ["random", "one_hot", "word2vec", "one_hot_word2vec", "bert_cate", "none"])
def test_auxiliary_matches_jax(fea_type):
    item2id = {10: 0, 11: 1, 12: 2, 15: 4}
    kwargs = dict(config={}, n_users=7, n_items=5, item2id=item2id, seed=3)
    want, got = jax_aux.Auxiliary(**kwargs), auxiliary_data.Auxiliary(**kwargs)
    for _ in range(2):  # the generator's state carries over between calls
        w, g = want.item_features(fea_type, dim=6, load_fn=_fea_loader), got.item_features(fea_type, 6, _fea_loader)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got.user_features(dim=4), want.user_features(dim=4))
    with pytest.raises(NotImplementedError):
        got.user_features("one_hot", load_fn=_fea_loader)


# -- the loaders ----------------------------------------------------------------------

def _split(seed=0, n_users=30, n_items=25, n=300):
    rng = np.random.default_rng(seed)
    frame = {U: rng.integers(0, n_users, n) * 3 + 1, I: rng.integers(0, n_items, n) * 7,
             R: rng.integers(0, 3, n).astype(np.float32), DEFAULT_TIMESTAMP_COL: rng.integers(0, 1000, n)}
    valid = {k: v[:40] for k, v in frame.items()}
    return frame, valid


def _both_data():
    train, valid = _split()
    want = JaxBaseData((pd.DataFrame(train), pd.DataFrame(valid), pd.DataFrame(valid)))
    got = BaseData((train, valid, valid))
    np.testing.assert_array_equal(got.pos_bitmask(), want.pos_bitmask())
    return want, got


def _same_batches(want, got):
    want, got = list(want), list(got)
    assert len(got) == len(want) > 1
    for w_batch, g_batch in zip(want, got):
        for w, g in zip(w_batch, g_batch):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("loader", ["bpr", "bpr_rounds", "bce", "vae", "vae_in_order", "mul_neg"])
def test_loaders_match_jax(loader):
    want_data, got_data = _both_data()
    call = {
        "bpr": lambda mod, data, rng: mod.instance_bpr_loader(data, 64, rng=rng),
        "bpr_rounds": lambda mod, data, rng: mod.instance_bpr_loader(data, 50, rng=rng, num_rounds=3),
        "bce": lambda mod, data, rng: mod.instance_bce_loader(data, 4, 128, rng=rng),
        "vae": lambda mod, data, rng: mod.instance_vae_loader(data, 8, rng=rng),
        "vae_in_order": lambda mod, data, rng: mod.instance_vae_loader(data, 7, rng=rng, shuffle=False),
        "mul_neg": lambda mod, data, rng: mod.instance_mul_neg_loader(data, 5, 32, rng=rng),
    }[loader]
    _same_batches(call(jax_loaders, want_data, np.random.default_rng(9)),
                  call(data_loaders, got_data, np.random.default_rng(9)))


def test_rating_and_pairwise_datasets_match_jax():
    users, items, ratings = [3, 1, 2], [0, 5, 4], [1, 0.5, 2]
    for cls in ("RatingDataset", "PairwiseNegativeDataset"):
        want, got = getattr(jax_loaders, cls)(users, items, ratings), getattr(data_loaders, cls)(users, items, ratings)
        assert len(got) == len(want) == 3
        for w, g in zip(want[1:], got[1:]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# -- UnigramTable -------------------------------------------------------------------

@pytest.mark.parametrize("freq", ["array", "dict", "sized"])
def test_unigram_table_matches_jax(freq):
    rng = np.random.default_rng(1)
    counts = rng.integers(1, 500, 40)
    obj_freq, kwargs = {"array": (counts, {}), "dict": ({f"w{i}": int(c) for i, c in enumerate(counts)}, {}),
                        "sized": (counts, {"table_size": 5000, "power": 0.5})}[freq]
    want, got = JaxUnigramTable(obj_freq, **kwargs), UnigramTable(obj_freq, **kwargs)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.random.seed(21)
    expected = want.sample(1000)
    np.testing.assert_array_equal(got.sample(1000, np.random.RandomState(21)), expected)
    gen = np.random.default_rng(4)
    np.testing.assert_array_equal(got.sample(300, np.random.default_rng(4)),
                                  got.labels[got.table[gen.integers(0, len(got.table), size=300)]])


# -- utils/evaluation.py ---------------------------------------------------------------

def _frames(seed=0, string_users=False):
    """Truth with a user whose ratings are all 0, duplicated truth rows and a
    user beyond k; predictions with ties (rounded scores) and a user absent
    from the truth."""
    rng = np.random.default_rng(seed)
    users = np.repeat(np.arange(12), rng.integers(1, 16, 12))
    items = np.concatenate([rng.choice(30, (users == u).sum(), replace=False) for u in range(12)])
    pred = {U: users, I: items, P: np.round(rng.random(len(users)), 1)}
    pick = rng.random(len(users)) < 0.4
    truth = {U: users[pick], I: items[pick], R: rng.integers(0, 3, pick.sum()).astype(np.float64)}
    truth[R][truth[U] == 3] = 0.0  # no relevant item
    truth = {k: np.concatenate([v, v[:3]]) for k, v in truth.items()}  # duplicated rows
    pred = {k: np.concatenate([v, np.asarray(x)]) for (k, v), x in zip(pred.items(), ([40, 40], [1, 2], [0.5, 0.5]))}
    if string_users:
        truth[U], pred[U] = (np.array([f"u{x:02d}" for x in f[U]], dtype=object) for f in (truth, pred))
    return truth, pred


@pytest.mark.parametrize("string_users", [False, True])
@pytest.mark.parametrize("k", [1, 3, 10, 40])
@pytest.mark.parametrize("metric", ["precision", "recall", "ndcg", "map"])
def test_ranking_metrics_match_jax(metric, k, string_users):
    truth, pred = _frames(0, string_users)
    want = jax_eval.METRIC_FNS[metric](pd.DataFrame(truth), pd.DataFrame(pred), k=k)
    got = evaluation.METRIC_FNS[metric](truth, pred, k=k)
    assert abs(got - want) <= 1e-12 and want > 0, (got, want)


def test_by_threshold_and_no_hits_match_jax():
    truth, pred = _frames(1)
    for kw in ({"relevancy_method": "by_threshold", "threshold": 2}, {"k": 5}):
        for metric in ("precision", "recall", "ndcg", "map"):
            want = jax_eval.METRIC_FNS[metric](pd.DataFrame(truth), pd.DataFrame(pred), **kw)
            assert abs(evaluation.METRIC_FNS[metric](truth, pred, **kw) - want) <= 1e-12
    no_hit = dict(truth, **{I: truth[I] + 100})
    for metric in ("precision", "recall", "ndcg", "map"):
        assert evaluation.METRIC_FNS[metric](no_hit, pred) == jax_eval.METRIC_FNS[metric](
            pd.DataFrame(no_hit), pd.DataFrame(pred)) == 0.0


@pytest.mark.parametrize("k", [2, 10])
def test_top_k_and_merge_match_jax(k):
    truth, pred = _frames(3)
    want = jax_eval.get_top_k_items(pd.DataFrame(pred), col_rating=P, k=k)
    got = evaluation.get_top_k_items(pred, col_rating=P, k=k)
    assert list(got) == list(want.columns)
    for col in want.columns:
        np.testing.assert_array_equal(got[col], want[col].to_numpy(), err_msg=col)
    w_hit, w_count, w_n = jax_eval.merge_ranking_true_pred(pd.DataFrame(truth), pd.DataFrame(pred), k=k)
    g_hit, g_count, g_n = evaluation.merge_ranking_true_pred(truth, pred, k=k)
    assert g_n == w_n
    for got_frame, want_frame in ((g_hit, w_hit), (g_count, w_count)):
        assert list(got_frame) == list(want_frame.columns)
        for col in want_frame.columns:
            np.testing.assert_array_equal(got_frame[col], want_frame[col].to_numpy(), err_msg=col)


@pytest.mark.parametrize("metric", ["rmse", "mae", "rsquared", "exp_var", "auc", "logloss"])
@pytest.mark.parametrize("pred_dtype", [np.float64, np.float32])
def test_rating_metrics_match_jax(metric, pred_dtype):
    rng = np.random.default_rng(7)
    n = 200
    truth = {U: rng.integers(0, 20, n), I: rng.integers(0, 50, n), R: rng.integers(0, 2, n).astype(np.float64)}
    pred = {U: rng.permutation(truth[U]), I: truth[I].copy(),
            P: np.round(rng.random(n), 2).astype(pred_dtype)}  # ties
    pred[U][:150] = truth[U][:150]  # 150+ pairs join, some twice
    pred[P][:3] = [0.0, 1.0, 1.0]  # clipped by logloss
    want = jax_eval.METRIC_FNS[metric](pd.DataFrame(truth), pd.DataFrame(pred))
    got = evaluation.METRIC_FNS[metric](truth, pred)
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (got, want)


def test_rating_metric_checks_raise_as_jax():
    truth, pred = _frames(0)
    with pytest.raises(ValueError, match="Missing column"):
        evaluation.rmse(truth, {U: pred[U], I: pred[I]})
    with pytest.raises(ValueError, match="Mismatched dtype"):
        evaluation.rmse(truth, dict(pred, **{I: pred[I].astype(np.float64)}))
    with pytest.raises(ValueError):
        evaluation.auc(dict(truth, **{R: np.ones(len(truth[R]))}), pred)


def test_frame_hash_keys_an_lru_cache():
    calls = []

    @evaluation.lru_cache_df(maxsize=4)
    def rows(frame, k=1):
        calls.append(k)
        return len(frame[U]) * k

    truth, _ = _frames(0)
    same = {col: values.copy() for col, values in truth.items()}
    assert rows(truth) == rows(same) == len(truth[U]) and calls == [1]
    assert rows(truth, k=2) == 2 * len(truth[U]) and calls == [1, 2]
    changed = dict(truth, **{R: truth[R] + 1})
    rows(changed)
    assert calls == [1, 2, 1] and rows.cache_info().hits == 1
    assert evaluation.FrameHash(truth) == evaluation.FrameHash(same) != evaluation.FrameHash(changed)
    strings = {U: np.array(["a", "b"], dtype=object)}
    assert hash(evaluation.FrameHash(strings)) == hash(evaluation.FrameHash({U: np.array(["a", "b"], dtype=object)}))
