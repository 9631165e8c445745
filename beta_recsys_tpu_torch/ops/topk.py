"""Exact top-k with the reference's tie order."""

import torch


def topk_lowest_index(scores, k):
    """(values, indices) of the k largest entries of each row, ties broken
    toward the lowest index as ``lax.top_k`` breaks them. ``torch.topk`` does
    not promise that order; a stable descending sort does."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
