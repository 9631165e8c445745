"""Ranking metrics over padded candidate matrices, and rating metrics.

Counterpart of ``beta_recsys_tpu/ops/metrics.py``. Ranking: precision
normalized by k, recall and MAP by each user's relevant count, NDCG with
gains 1/log1p(rank), ties ranked toward the lowest candidate slot. Rating
(pointwise, with an optional validity mask): rmse, mae, rsquared, exp_var,
auc (the rank statistic, tied predictions at their average rank) and
logloss.

Inputs:
    scores:    (U, C) float — per-user candidate scores.
    relevance: (U, C) float — 1.0 where the candidate is a true positive.
    mask:      (U, C) bool — True for valid candidate slots.
A user with no relevant candidate contributes 0 to every metric mean.
"""

import torch

from .topk import NEG_INF, topk_lowest_index


def _topk_relevance(scores, relevance, mask, k):
    """(U, k) relevance of each user's top-k candidates by descending score,
    zero-padded to k when k exceeds the candidate count."""
    kk = min(k, scores.shape[1])
    _, idx = topk_lowest_index(scores.masked_fill(~mask, NEG_INF), kk)
    out = torch.gather(relevance, 1, idx) * torch.gather(mask, 1, idx)
    if kk < k:
        out = torch.nn.functional.pad(out, (0, k - kk))
    return out


def _actual_counts(relevance, mask):
    return (relevance * mask).sum(dim=1)


def _gains(k, like):
    ranks = torch.arange(1, k + 1, dtype=like.dtype, device=like.device)
    return ranks, 1.0 / torch.log1p(ranks)


def _precision(top_rel, actual, k):
    return (top_rel[:, :k].sum(dim=1) / k).mean()


def _recall(top_rel, actual, k):
    hits = top_rel[:, :k].sum(dim=1)
    return torch.where(actual > 0, hits / actual.clamp(min=1), 0.0).mean()


def _ndcg(top_rel, actual, k):
    _, gains = _gains(k, top_rel)
    dcg = (top_rel[:, :k] * gains).sum(dim=1)
    # IDCG = prefix sums of the gain sequence up to min(actual, k).
    idx = (actual.clamp(max=k).long() - 1).clamp(0, k - 1)
    idcg = torch.cumsum(gains, dim=0)[idx]
    return torch.where(actual > 0, dcg / idcg, 0.0).mean()


def _map(top_rel, actual, k):
    ranks, _ = _gains(k, top_rel)
    top = top_rel[:, :k]
    hit_counts = torch.cumsum(top, dim=1)  # j at the j-th hit
    rr = (top * hit_counts / ranks).sum(dim=1)
    return torch.where(actual > 0, rr / actual.clamp(min=1), 0.0).mean()


_FROM_TOP = {"precision": _precision, "recall": _recall, "ndcg": _ndcg, "map": _map}


def _metric(name):
    def fn(scores, relevance, mask, k):
        return _FROM_TOP[name](_topk_relevance(scores, relevance, mask, k), _actual_counts(relevance, mask), k)
    fn.__name__ = f"{name}_at_k"
    return fn


precision_at_k = _metric("precision")
recall_at_k = _metric("recall")
ndcg_at_k = _metric("ndcg")
map_at_k = _metric("map")

RANKING_METRICS = {
    "precision": precision_at_k,
    "recall": recall_at_k,
    "ndcg": ndcg_at_k,
    "map": map_at_k,
}


def metrics_from_top(top_rel, actual, metrics, ks):
    """{metric@k: 0-d tensor} for every metric and k (metric-major, as the
    JAX package orders them) from each user's (U, max(ks)) relevance of its
    top items in rank order and its (U,) relevant count."""
    for m in metrics:
        if m not in _FROM_TOP:
            raise KeyError(m)
    return {f"{m}@{k}": _FROM_TOP[m](top_rel, actual, k) for m in metrics for k in ks}


def ranking_metrics(scores, relevance, mask, metrics, ks):
    """``metrics_from_top`` of the candidates' scores. One top-k at the
    largest k serves every k: with ties toward the lowest slot, the top k
    is a prefix of the top K."""
    for m in metrics:
        if m not in _FROM_TOP:
            raise KeyError(m)
    top_rel = _topk_relevance(scores, relevance, mask, max(ks))
    return metrics_from_top(top_rel, _actual_counts(relevance, mask), metrics, ks)


# ---------------------------------------------------------------------------
# Rating metrics (pointwise, fixed shape with a validity mask)
# ---------------------------------------------------------------------------


def _masked_sum(x, mask):
    return torch.where(mask, x, 0.0).sum() if mask is not None else x.sum()


def _masked_mean(x, mask):
    if mask is None:
        return x.mean()
    return _masked_sum(x, mask) / mask.sum().clamp(min=1)


def rmse(y_true, y_pred, mask=None):
    return torch.sqrt(_masked_mean((y_true - y_pred) ** 2, mask))


def mae(y_true, y_pred, mask=None):
    return _masked_mean((y_true - y_pred).abs(), mask)


def rsquared(y_true, y_pred, mask=None):
    ss_res = _masked_sum((y_true - y_pred) ** 2, mask)
    ss_tot = _masked_sum((y_true - _masked_mean(y_true, mask)) ** 2, mask)
    return 1.0 - ss_res / ss_tot


def exp_var(y_true, y_pred, mask=None):
    err = y_true - y_pred
    var_err = _masked_mean((err - _masked_mean(err, mask)) ** 2, mask)
    var_true = _masked_mean((y_true - _masked_mean(y_true, mask)) ** 2, mask)
    return 1.0 - var_err / var_true


def auc(y_true, y_pred, mask=None):
    """Probability that a random positive (y_true > 0) outranks a random
    negative: the Mann-Whitney U over ascending ranks, tied predictions
    sharing their average rank (1/2 a tied pair, as sklearn's roc_auc_score).
    Masked-out entries rank last and count on neither side."""
    if mask is None:
        mask = torch.ones_like(y_pred, dtype=torch.bool)
    pos = (y_true > 0) & mask
    neg = (y_true <= 0) & mask
    y_pred = torch.where(mask, y_pred, torch.inf)
    sorted_pred, order = torch.sort(y_pred, stable=True)
    _, counts = torch.unique_consecutive(sorted_pred, return_counts=True)
    # A group of c equal predictions from rank s + 1 has average rank s + (c + 1) / 2.
    starts = (torch.cumsum(counts, 0) - counts).to(y_pred.dtype)
    avg = torch.repeat_interleave(starts + (counts.to(y_pred.dtype) + 1) / 2, counts)
    ranks = torch.empty_like(avg).scatter_(0, order, avg)
    n_pos, n_neg = pos.sum().to(y_pred.dtype), neg.sum().to(y_pred.dtype)
    u_stat = torch.where(pos, ranks, 0.0).sum() - n_pos * (n_pos + 1) / 2.0
    return u_stat / (n_pos * n_neg).clamp(min=1)


def logloss(y_true, y_pred, mask=None, eps=1e-15):
    p = y_pred.clamp(eps, 1 - eps)
    return _masked_mean(-(y_true * torch.log(p) + (1 - y_true) * torch.log1p(-p)), mask)


RATING_METRICS = {
    "rmse": rmse,
    "mae": mae,
    "rsquared": rsquared,
    "exp_var": exp_var,
    "auc": auc,
    "logloss": logloss,
}
