"""Rating evaluation against the JAX package: the rating reductions of
``ops/metrics.py`` (auc with tied scores, masks), ``RatingEvaluator`` on an
MF with the same weights, and ``BaseData``'s ``intersect``, ``binarize``,
``bin_thld`` and ``normalize`` (also through ``GroceryData`` and
``SequentialData``) giving the JAX frames."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from beta_recsys_tpu.core.rating_eval import RatingEvaluator as JaxRatingEvaluator
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.data.grocery_data import GroceryData as JaxGroceryData
from beta_recsys_tpu.data.sequential_data import SequentialData as JaxSequentialData
from beta_recsys_tpu.models.mf import MF as JaxMF
from beta_recsys_tpu.ops import metrics as jax_metrics
from beta_recsys_tpu_torch.convert import params_to_jax
from beta_recsys_tpu_torch.core.rating_eval import RatingEvaluator
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.data.grocery_data import GroceryData
from beta_recsys_tpu_torch.data.sequential_data import SequentialData
from beta_recsys_tpu_torch.models.mf import MF
from beta_recsys_tpu_torch.ops import metrics
from beta_recsys_tpu_torch.utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_ORDER_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)

# float32 reductions over a few hundred values summed in another order
TOL = 2e-6


def _inputs(seed, n=300, ties=False):
    rng = np.random.default_rng(seed)
    y_true = rng.integers(0, 2, n).astype(np.float32)
    y_pred = rng.random(n).astype(np.float32)
    if ties:
        y_pred = (np.round(y_pred * 4) / 4).astype(np.float32)  # five distinct scores
    mask = rng.random(n) < 0.8
    return y_true, y_pred, mask


@pytest.mark.parametrize("name", sorted(metrics.RATING_METRICS))
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_rating_metrics_equal_jax(name, ties, masked):
    y_true, y_pred, mask = _inputs(1, ties=ties)
    if name not in ("auc", "logloss"):
        y_true = y_true * 4 + np.random.default_rng(2).random(len(y_true)).astype(np.float32)
    got = metrics.RATING_METRICS[name](torch.from_numpy(y_true), torch.from_numpy(y_pred),
                                       torch.from_numpy(mask) if masked else None)
    want = getattr(jax_metrics, name)(jnp.asarray(y_true), jnp.asarray(y_pred), jnp.asarray(mask) if masked else None)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)


def test_auc_counts_a_tied_pair_as_a_half():
    got = metrics.auc(torch.tensor([1.0, 0.0, 1.0, 0.0]), torch.tensor([0.5, 0.5, 0.9, 0.1]))
    assert float(got) == pytest.approx((1 + 1 + 1 + 0.5) / 4)


def _frame(seed=0, n_users=30, n_items=25, n=300, rated=True):
    rng = np.random.default_rng(seed)
    return {DEFAULT_USER_COL: rng.integers(0, n_users, n), DEFAULT_ITEM_COL: rng.integers(0, n_items, n),
            DEFAULT_RATING_COL: rng.integers(0, 6, n).astype(np.float64) if rated else np.ones(n),
            DEFAULT_TIMESTAMP_COL: np.arange(n)}


def test_rating_evaluator_equals_jax():
    data = BaseData((_frame(0), _frame(1), _frame(2)), binarize=False)
    model = MF({"emb_dim": 6}, data.n_users, data.n_items, device="cpu").init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.user_bias.normal_(0, 1, generator=torch.Generator().manual_seed(1))
    names = sorted(metrics.RATING_METRICS)
    got = RatingEvaluator(model, data.test[0], names).evaluate()
    ref_model = JaxMF({"emb_dim": 6}, data.n_users, data.n_items)
    params = {k: jnp.asarray(v) for k, v in params_to_jax(model.state_dict()).items()}
    want = JaxRatingEvaluator(ref_model, pd.DataFrame(data.test[0]), names).evaluate(params)
    assert list(got) == names
    for key in names:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=key)
    with pytest.raises(ValueError, match="Unknown rating metrics"):
        RatingEvaluator(model, data.test[0], ("rmse", "ndcg"))


def _split_with_unseen(seed=3):
    """Train, and valid/test frames holding ids that train never saw."""
    train = _frame(seed, n_users=20, n_items=15)
    valid, test = _frame(seed + 1, n_users=25, n_items=18), _frame(seed + 2, n_users=25, n_items=18)
    return train, [valid], [test]


def _to_jax(split):
    train, valid, test = split
    return pd.DataFrame(train), [pd.DataFrame(f) for f in valid], [pd.DataFrame(f) for f in test]


def _assert_frames(ours, ref):
    np.testing.assert_array_equal(ours.user_pool, ref.user_pool)
    np.testing.assert_array_equal(ours.item_pool, ref.item_pool)
    for frame, df in [(ours.train, ref.train), *zip(ours.valid, ref.valid), *zip(ours.test, ref.test)]:
        assert len(frame[DEFAULT_USER_COL]) == len(df)
        for col in (DEFAULT_USER_COL, DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_TIMESTAMP_COL):
            np.testing.assert_array_equal(frame[col], df[col].to_numpy(), err_msg=col)
            assert frame[col].dtype == df[col].dtype, col


OPTIONS = [
    {},
    {"intersect": False},
    {"binarize": False},
    {"bin_thld": 2.0},
    {"binarize": False, "normalize": True},
    {"normalize": True, "bin_thld": 3.0},
    {"intersect": False, "binarize": False, "normalize": True},
]


@pytest.mark.parametrize("options", OPTIONS)
@pytest.mark.parametrize("kind", ["base", "sequential", "grocery"])
def test_base_data_options_equal_jax(options, kind):
    split = _split_with_unseen()
    if kind == "grocery":
        split = tuple({**f, DEFAULT_ORDER_COL: np.arange(len(f[DEFAULT_USER_COL])) // 3} if isinstance(f, dict)
                      else [{**g, DEFAULT_ORDER_COL: np.arange(len(g[DEFAULT_USER_COL])) // 3} for g in f]
                      for f in split)
    cls, jax_cls = {"base": (BaseData, JaxBaseData), "sequential": (SequentialData, JaxSequentialData),
                    "grocery": (GroceryData, JaxGroceryData)}[kind]
    ours = cls(split, **options)
    ref = jax_cls(_to_jax(split), **options)
    _assert_frames(ours, ref)
    if not options.get("intersect", True):
        assert np.isnan(ours.test[0][DEFAULT_USER_COL]).any()


def test_default_options_leave_frames_as_before():
    """The defaults give the frames the port gave before the options."""
    split = _split_with_unseen(5)
    a, b = BaseData(split), BaseData(split, intersect=True, binarize=True, bin_thld=0.0, normalize=False)
    for fa, fb in [(a.train, b.train), (a.test[0], b.test[0])]:
        for col in fa:
            assert np.array_equal(fa[col], fb[col]) and fa[col].dtype == fb[col].dtype
    assert a.test[0][DEFAULT_USER_COL].dtype == np.int64
