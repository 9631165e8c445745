"""Host-side rating and ranking metrics on frames of numpy columns: the
golden versions that the device metrics (``ops/metrics.py``) are held to.

Counterpart of ``beta_recsys_tpu/utils/evaluation.py`` without pandas or
sklearn. A frame is a dict {column name: numpy array}. The semantics are the
JAX package's (Spark-style ranking metrics): each user's top k by prediction
with ties in frame order ('first'), precision normalized by k, recall and
MAP by the user's relevant count (rating >= 1), NDCG with 1/log1p(rank)
gains; the joins are pandas' inner merges (``utils/common.inner_join_rows``). ``FrameHash`` and
``lru_cache_df`` are ``PandasHash`` and ``lru_cache_df`` for such frames.
"""

import functools
import hashlib

import numpy as np

from .common import inner_join_rows
from .constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_K,
    DEFAULT_PREDICTION_COL,
    DEFAULT_RATING_COL,
    DEFAULT_THRESHOLD,
    DEFAULT_USER_COL,
)


def _is_frame(value):
    return isinstance(value, dict) and all(isinstance(v, np.ndarray) for v in value.values())


class FrameHash:
    """A frame made hashable by its content (column names, dtypes, shapes
    and values), so that it can key an ``lru_cache``."""

    def __init__(self, frame):
        self.frame = frame
        self._key = tuple((col, values.dtype.str, values.shape, hashlib.sha1(
            (values.astype(str) if values.dtype == object else np.ascontiguousarray(values)).tobytes()).hexdigest())
            for col, values in frame.items())
        self._hash = hash(self._key)

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, FrameHash) and self._key == other._key


def lru_cache_df(maxsize=128):
    """``functools.lru_cache`` for functions that take frames: each frame
    argument is keyed by its ``FrameHash`` and handed on unwrapped."""

    def decorator(fn):
        @functools.lru_cache(maxsize=maxsize)
        def cached(*args, **kwargs):
            args = tuple(a.frame if isinstance(a, FrameHash) else a for a in args)
            kwargs = {k: (v.frame if isinstance(v, FrameHash) else v) for k, v in kwargs.items()}
            return fn(*args, **kwargs)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            args = tuple(FrameHash(a) if _is_frame(a) else a for a in args)
            kwargs = {k: (FrameHash(v) if _is_frame(v) else v) for k, v in kwargs.items()}
            return cached(*args, **kwargs)

        wrapper.cache_info = cached.cache_info
        wrapper.cache_clear = cached.cache_clear
        return wrapper

    return decorator


# -- frame helpers ----------------------------------------------------------------------

def _take(frame, rows):
    return {col: np.asarray(values)[rows] for col, values in frame.items()}


def _cumcount(keys):
    """groupby(keys).cumcount(): each row's position among its key's rows."""
    codes = np.unique(keys, return_inverse=True)[1].reshape(-1)
    order = np.argsort(codes, kind="stable")
    sorted_codes = codes[order]
    starts = np.searchsorted(sorted_codes, sorted_codes, "left")
    out = np.empty(len(keys), dtype=np.int64)
    out[order] = np.arange(len(keys)) - starts
    return out


def _group_sums(keys, values, sort=True):
    """(distinct keys, the sum of ``values`` over each), keys sorted or, with
    ``sort=False``, in order of first appearance."""
    uniq, first, inverse = np.unique(keys, return_index=True, return_inverse=True)
    sums = np.bincount(inverse.reshape(-1), weights=values, minlength=len(uniq))
    visit = np.arange(len(uniq)) if sort else np.argsort(first, kind="stable")
    return uniq[visit], sums[visit]


def _descending(values):
    """pandas' ``sort_values(ascending=False, kind="stable")`` order: ties
    in frame order, NaN last."""
    values = np.asarray(values)
    idx = np.arange(len(values))
    nan = np.isnan(values) if values.dtype.kind == "f" else np.zeros(len(values), bool)
    kept, kept_idx = values[~nan][::-1], idx[~nan][::-1]
    return np.concatenate([kept_idx[kept.argsort(kind="stable")][::-1], idx[nan]])


def _check_columns(rating_true, rating_pred, col_user, col_item, col_rating, col_prediction):
    """The expected columns exist, with one dtype a key column in both frames."""
    for frame, col in [(rating_true, col_user), (rating_true, col_item), (rating_true, col_rating),
                       (rating_pred, col_user), (rating_pred, col_item), (rating_pred, col_prediction)]:
        if col not in frame:
            raise ValueError(f"Missing column {col} in DataFrame")
    for col in (col_user, col_item):
        if np.asarray(rating_true[col]).dtype != np.asarray(rating_pred[col]).dtype:
            raise ValueError(f"Mismatched dtype for column {col}")


# -- rating metrics -------------------------------------------------------------------

def merge_rating_true_pred(rating_true, rating_pred, col_user=DEFAULT_USER_COL, col_item=DEFAULT_ITEM_COL,
                           col_rating=DEFAULT_RATING_COL, col_prediction=DEFAULT_PREDICTION_COL):
    """The (true rating, prediction) arrays of the pairs in both frames."""
    _check_columns(rating_true, rating_pred, col_user, col_item, col_rating, col_prediction)
    left, right = inner_join_rows([rating_true[col_user], rating_true[col_item]],
                                  [rating_pred[col_user], rating_pred[col_item]])
    return np.asarray(rating_true[col_rating])[left], np.asarray(rating_pred[col_prediction])[right]


def rmse(rating_true, rating_pred, **kwargs):
    """Root mean squared error over the joined (user, item) pairs."""
    y_true, y_pred = merge_rating_true_pred(rating_true, rating_pred, **kwargs)
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


def mae(rating_true, rating_pred, **kwargs):
    """Mean absolute error over the joined (user, item) pairs."""
    y_true, y_pred = merge_rating_true_pred(rating_true, rating_pred, **kwargs)
    return float(np.mean(np.abs(y_true - y_pred)))


def rsquared(rating_true, rating_pred, **kwargs):
    """Coefficient of determination R^2."""
    y_true, y_pred = merge_rating_true_pred(rating_true, rating_pred, **kwargs)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - np.mean(y_true)) ** 2)
    return float(1.0 - ss_res / ss_tot)


def exp_var(rating_true, rating_pred, **kwargs):
    """Explained variance."""
    y_true, y_pred = merge_rating_true_pred(rating_true, rating_pred, **kwargs)
    return float(1.0 - np.var(y_true - y_pred) / np.var(y_true))


def _binary(y_true):
    """The positive-class mask of two-valued labels (the larger value is
    positive, as sklearn's label binarizer takes it)."""
    classes = np.unique(y_true)
    if len(classes) != 2:
        raise ValueError(f"y_true holds {len(classes)} classes; the metric needs two")
    return y_true == classes[1]


def auc(rating_true, rating_pred, **kwargs):
    """Area under the ROC curve (``roc_auc_score``): the Mann-Whitney
    statistic with tied predictions at their mean rank."""
    y_true, y_pred = merge_rating_true_pred(rating_true, rating_pred, **kwargs)
    pos = _binary(y_true)
    _, inverse, counts = np.unique(y_pred, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inverse.reshape(-1)]
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def logloss(rating_true, rating_pred, **kwargs):
    """Binary cross-entropy of the predicted probabilities (``log_loss``:
    clipped to [eps, 1 - eps] of their float type)."""
    y_true, y_pred = merge_rating_true_pred(rating_true, rating_pred, **kwargs)
    pos = _binary(y_true)
    if y_pred.dtype not in (np.float64, np.float32, np.float16):
        y_pred = y_pred.astype(np.float64)
    if y_pred.max() > 1 or y_pred.min() < 0:
        raise ValueError("y_pred holds values outside [0, 1]")
    eps = np.finfo(y_pred.dtype).eps
    proba = np.clip(np.stack([1 - y_pred, y_pred], axis=1), eps, 1 - eps)
    return float(np.mean(-np.log(np.where(pos, proba[:, 1], proba[:, 0]))))


# -- ranking metrics ------------------------------------------------------------------

def get_top_k_items(frame, col_user=DEFAULT_USER_COL, col_rating=DEFAULT_RATING_COL, k=DEFAULT_K):
    """Each user's top-k rows by ``col_rating`` (ties in frame order), the
    users in sorted order, with a 1-based "rank" column."""
    order = _descending(frame[col_rating])
    order = order[_cumcount(np.asarray(frame[col_user])[order]) < k]
    order = order[np.argsort(np.asarray(frame[col_user])[order], kind="stable")]
    top_k = _take(frame, order)
    top_k["rank"] = _cumcount(top_k[col_user]) + 1
    return top_k


def merge_ranking_true_pred(rating_true, rating_pred, col_user=DEFAULT_USER_COL, col_item=DEFAULT_ITEM_COL,
                            col_rating=DEFAULT_RATING_COL, col_prediction=DEFAULT_PREDICTION_COL,
                            relevancy_method="top_k", k=DEFAULT_K, threshold=DEFAULT_THRESHOLD):
    """The hits of each user's top-k predictions among the relevant truth
    (rating >= 1), over the users in both frames.

    Returns (df_hit: {user, item, rank} of each hit, df_hit_count: {user,
    hit, actual} of each user with a hit, users sorted, n_users)."""
    _check_columns(rating_true, rating_pred, col_user, col_item, col_rating, col_prediction)
    rating_true = _take(rating_true, np.asarray(rating_true[col_rating]) >= 1)
    common = np.intersect1d(rating_true[col_user], rating_pred[col_user])
    true_common = _take(rating_true, np.isin(rating_true[col_user], common))
    pred_common = _take(rating_pred, np.isin(rating_pred[col_user], common))
    if relevancy_method == "top_k":
        top_k = k
    elif relevancy_method == "by_threshold":
        top_k = threshold
    else:
        raise NotImplementedError("Invalid relevancy_method")

    top = get_top_k_items(pred_common, col_user=col_user, col_rating=col_prediction, k=top_k)
    left, _ = inner_join_rows([top[col_user], top[col_item]], [true_common[col_user], true_common[col_item]])
    df_hit = {col_user: top[col_user][left], col_item: top[col_item][left], "rank": top["rank"][left]}

    hit_users, hits = np.unique(df_hit[col_user], return_counts=True)
    actual_users, actual = np.unique(true_common[col_user], return_counts=True)
    df_hit_count = {col_user: hit_users, "hit": hits,
                    "actual": actual[np.searchsorted(actual_users, hit_users)]}
    return df_hit, df_hit_count, len(common)


def precision_at_k(rating_true, rating_pred, k=DEFAULT_K, **kwargs):
    """Precision@k averaged over users, normalized by k."""
    df_hit, df_hit_count, n_users = merge_ranking_true_pred(rating_true, rating_pred, k=k, **kwargs)
    if len(df_hit["rank"]) == 0:
        return 0.0
    return float((df_hit_count["hit"] / k).sum() / n_users)


def recall_at_k(rating_true, rating_pred, k=DEFAULT_K, **kwargs):
    """Recall@k averaged over users, normalized by each user's relevant count."""
    df_hit, df_hit_count, n_users = merge_ranking_true_pred(rating_true, rating_pred, k=k, **kwargs)
    if len(df_hit["rank"]) == 0:
        return 0.0
    return float((df_hit_count["hit"] / df_hit_count["actual"]).sum() / n_users)


def ndcg_at_k(rating_true, rating_pred, k=DEFAULT_K, **kwargs):
    """NDCG@k with binary relevance: gain 1/log1p(rank), the ideal over
    min(actual, k) hits."""
    col_user = kwargs.get("col_user", DEFAULT_USER_COL)
    df_hit, df_hit_count, n_users = merge_ranking_true_pred(rating_true, rating_pred, k=k, **kwargs)
    if len(df_hit["rank"]) == 0:
        return 0.0
    users, dcg = _group_sums(df_hit[col_user], 1.0 / np.log1p(df_hit["rank"]), sort=False)
    actual = df_hit_count["actual"][np.searchsorted(df_hit_count[col_user], users)]
    idcg = np.array([sum(1.0 / np.log1p(r) for r in range(1, min(x, k) + 1)) for x in actual.tolist()])
    return float((dcg / idcg).sum() / n_users)


def map_at_k(rating_true, rating_pred, k=DEFAULT_K, **kwargs):
    """MAP@k: the mean over users of the precision at each hit's rank,
    summed, over the user's relevant count."""
    col_user = kwargs.get("col_user", DEFAULT_USER_COL)
    df_hit, df_hit_count, n_users = merge_ranking_true_pred(rating_true, rating_pred, k=k, **kwargs)
    if len(df_hit["rank"]) == 0:
        return 0.0
    order = np.lexsort((df_hit["rank"], df_hit[col_user]))
    users, ranks = df_hit[col_user][order], df_hit["rank"][order]
    _, rr = _group_sums(users, (_cumcount(users) + 1) / ranks)
    return float((rr / df_hit_count["actual"]).sum() / n_users)


METRIC_FNS = {
    "rmse": rmse,
    "mae": mae,
    "rsquared": rsquared,
    "exp_var": exp_var,
    "auc": auc,
    "logloss": logloss,
    "precision": precision_at_k,
    "recall": recall_at_k,
    "ndcg": ndcg_at_k,
    "map": map_at_k,
}
