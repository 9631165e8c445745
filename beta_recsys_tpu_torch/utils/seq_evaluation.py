"""Sequential (session) metrics over ground-truth and predicted item lists.

Counterpart of ``beta_recsys_tpu/utils/seq_evaluation.py``: precision over
the distinct predictions, recall over the distinct ground truth, the
reciprocal rank of the first hit, and NDCG with binary gains and log2(rank +
2) discounts.
"""

import numpy as np


def _dedup(li):
    """Distinct entries in order; an entry may itself be a list."""
    seen, out = set(), []
    for x in li:
        key = tuple(x) if isinstance(x, (list, np.ndarray)) else x
        if key not in seen:
            seen.add(key)
            out.append(x)
    return out


def precision(ground_truth, prediction):
    """The share of distinct predictions found in the ground truth."""
    gt, pred = _dedup(ground_truth), _dedup(prediction)
    return sum(1 for p in pred if p in gt) / float(len(pred))


def recall(ground_truth, prediction):
    """The share of the distinct ground truth that the prediction recovers."""
    gt, pred = _dedup(ground_truth), _dedup(prediction)
    if len(pred) == 0:
        return 0
    return sum(1 for p in pred if p in gt) / float(len(gt))


def mrr(ground_truth, prediction):
    """1 / rank of the first relevant prediction; 0 without a hit."""
    for rank, p in enumerate(prediction):
        if p in ground_truth:
            return 1.0 / (rank + 1)
    return 0.0


def ndcg(ground_truth, prediction):
    """NDCG with binary relevance over the predicted ranking."""
    rel = np.array([1 if p in ground_truth else 0 for p in prediction])
    hit_ranks = np.nonzero(rel)[0]
    if len(hit_ranks) == 0:
        return 0.0
    dcg = np.sum((2.0 ** rel[hit_ranks] - 1) / np.log2(hit_ranks + 2))
    idcg = np.sum(1.0 / np.log2(np.arange(len(hit_ranks)) + 2))
    return float(dcg / idcg)
