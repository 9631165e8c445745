"""Ranking metrics over padded candidate matrices.

Counterpart of the ranking half of ``beta_recsys_tpu/ops/metrics.py``:
precision normalized by k, recall and MAP by each user's relevant count,
NDCG with gains 1/log1p(rank), ties ranked toward the lowest candidate slot.

Inputs:
    scores:    (U, C) float — per-user candidate scores.
    relevance: (U, C) float — 1.0 where the candidate is a true positive.
    mask:      (U, C) bool — True for valid candidate slots.
A user with no relevant candidate contributes 0 to every metric mean.
"""

import torch

from .topk import topk_lowest_index

NEG_INF = -1e30


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


def precision_at_k(scores, relevance, mask, k):
    hits = _topk_relevance(scores, relevance, mask, k).sum(dim=1)
    return (hits / k).mean()


def recall_at_k(scores, relevance, mask, k):
    hits = _topk_relevance(scores, relevance, mask, k).sum(dim=1)
    actual = _actual_counts(relevance, mask)
    return torch.where(actual > 0, hits / actual.clamp(min=1), 0.0).mean()


def ndcg_at_k(scores, relevance, mask, k):
    top_rel = _topk_relevance(scores, relevance, mask, k)
    ranks = torch.arange(1, k + 1, dtype=scores.dtype, device=scores.device)
    gains = 1.0 / torch.log1p(ranks)
    dcg = (top_rel * gains).sum(dim=1)
    actual = _actual_counts(relevance, mask)
    # IDCG = prefix sums of the gain sequence up to min(actual, k).
    idx = (actual.clamp(max=k).long() - 1).clamp(0, k - 1)
    idcg = torch.cumsum(gains, dim=0)[idx]
    return torch.where(actual > 0, dcg / idcg, 0.0).mean()


def map_at_k(scores, relevance, mask, k):
    top_rel = _topk_relevance(scores, relevance, mask, k)
    ranks = torch.arange(1, k + 1, dtype=scores.dtype, device=scores.device)
    hit_counts = torch.cumsum(top_rel, dim=1)  # j at the j-th hit
    rr = (top_rel * hit_counts / ranks).sum(dim=1)
    actual = _actual_counts(relevance, mask)
    return torch.where(actual > 0, rr / actual.clamp(min=1), 0.0).mean()


RANKING_METRICS = {
    "precision": precision_at_k,
    "recall": recall_at_k,
    "ndcg": ndcg_at_k,
    "map": map_at_k,
}


def ranking_metrics(scores, relevance, mask, metrics, ks):
    """{metric@k: 0-d tensor} for every metric and k."""
    return {
        f"{m}@{k}": RANKING_METRICS[m](scores, relevance, mask, k)
        for m in metrics
        for k in ks
    }
