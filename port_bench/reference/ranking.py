"""Full-catalog ranking metrics of one held-out item a user, by its rank.

The item's 0-based rank among the items not masked: those scoring above
it, and those scoring the same with a lower id (ties go to the lowest id).
From the rank r, with one relevant item: hit@k = r < k; precision@k =
hit / k; recall@k = hit; ndcg@k = hit * ln 2 / ln(r + 2); map@k =
hit / (r + 1). Sums are float64.
"""

import math

import torch


def held_out_ranks(scores, masked, items):
    """(U,) rank of ``items[u]`` in row u of ``scores`` over the unmasked
    entries."""
    own = scores.gather(1, items[:, None])
    ids = torch.arange(scores.shape[1], device=scores.device)
    ahead = (scores > own) | ((scores == own) & (ids[None, :] < items[:, None]))
    return (ahead & ~masked).sum(dim=1)


def metric_sums(ranks, metrics, ks):
    """{metric@k: float64 sum over users} from the ranks."""
    r = ranks.double()
    out = {}
    for m in metrics:
        for k in ks:
            hit = (r < k).double()
            value = {
                "precision": hit / k,
                "recall": hit,
                "ndcg": hit * math.log(2.0) / torch.log(r + 2.0),
                "map": hit / (r + 1.0),
            }[m]
            out[f"{m}@{k}"] = float(value.sum())
    return out
