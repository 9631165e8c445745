"""Exact top-k with the reference's tie order, and full-catalog retrieval.

Counterpart of ``beta_recsys_tpu/ops/topk.py``. Three entry points:

``topk_lowest_index`` - the k largest entries of each row, ties broken
toward the lowest index as ``lax.top_k`` breaks them. ``torch.topk`` does
not promise that order, and a full stable sort of a (4096, 162,000) block
is far more work than k needs. So ``torch.topk`` selects k + 1 candidates,
a sort of the first k by (value, index) orders ties, and the (k+1)-th value
finds the rows where the k-th value ties an entry that ``torch.topk`` left
out: it equals the k-th value in just those rows. Those rows, and the rows
where a -0.0 was taken (``lax.top_k`` ranks it below +0.0), are selected
again on int64 keys that order by value and then by lowest index, so every
row gets ``lax.top_k``'s exact answer.

``retrieval_topk`` - the serving fast path: one matmul of a user block
against the whole catalog, top ``k + T`` candidates, each user's T excluded
ids knocked out to ``NEG_INF`` by a compare, and top k again. With
``score_dtype="bfloat16"`` the matmul multiplies bfloat16 copies (the card
accumulates in float32 on the tensor cores) and the scores are bfloat16.

``streaming_topk`` - the memory-bounded path: the item table in blocks,
each block's scores merged into a running (B, k) buffer, so memory is
O(B * (block + k)) at any catalog size.
"""

import numpy as np
import torch

NEG_INF = -1e30

_LOW32 = 0xFFFFFFFF


def _keyed_topk(scores, rows, k, rows_per_chunk=1024):
    """``topk_lowest_index`` of ``scores[rows]`` through int64 keys: the
    float's bits made order-preserving in the high word (+0.0 above -0.0,
    as ``lax.top_k``'s total order has them), ``2**32 - 1 - index`` in the
    low word. Keys are distinct, so the top k of the keys is the answer.
    Rows go in chunks, so the keys of at most ``rows_per_chunk`` rows exist
    at once."""
    index = torch.arange(scores.shape[-1], device=scores.device, dtype=torch.int64)
    values, idx = [], []
    for start in range(0, rows.numel(), rows_per_chunk):
        chunk = scores[rows[start:start + rows_per_chunk]]
        bits = chunk.float().view(torch.int32).to(torch.int64)
        keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).mul_(1 << 32).add_(_LOW32 - index)
        idx.append(_LOW32 - (torch.topk(keys, k, dim=-1, sorted=True).values & _LOW32))
        values.append(torch.gather(chunk, -1, idx[-1]))
    return torch.cat(values), torch.cat(idx)


def _order_ties(values, idx):
    """(values, idx) of each row sorted by value descending, then index
    ascending: ``torch.topk`` leaves the order of equal values open."""
    idx, order = torch.sort(idx, dim=-1)
    values = torch.gather(values, -1, order)
    values, order = torch.sort(values, dim=-1, descending=True, stable=True)
    return values, torch.gather(idx, -1, order)


def topk_lowest_index(scores, k):
    """(values, indices) of the k largest entries of each row of a 2-D
    tensor, in descending order, ties broken toward the lowest index as
    ``lax.top_k`` breaks them. k is cut to the row length."""
    k = min(int(k), scores.shape[-1])
    if k == 0 or scores.shape[0] == 0:
        return scores[..., :k], torch.zeros(scores.shape[:-1] + (k,), dtype=torch.long, device=scores.device)
    values, idx = torch.topk(scores, min(k + 1, scores.shape[-1]), dim=-1, sorted=True)
    # A row whose k-th value ties an entry left out may hold the wrong one,
    # and a float compare cannot order a -0.0 it took against a +0.0.
    clash = (values[:, k:] == values[:, k - 1:k]).any(dim=-1)
    values, idx = _order_ties(values[:, :k], idx[:, :k])
    rows = (clash | ((values == 0) & torch.signbit(values)).any(dim=-1)).nonzero().flatten()
    if rows.numel():
        values[rows], idx[rows] = _keyed_topk(scores, rows, k)
    return values, idx


def exclusion_lists(csr, n_rows=None, pad=-1):
    """(n_rows, T_max) int32 per-row id lists of a scipy CSR, padded with
    ``pad``: every stored entry, zero-valued ones too, in CSR order. T_max
    is the largest row degree, at least 1. The ``exclude_list`` input of
    ``retrieval_topk`` (JAX ``exclusion_lists``, built here without a loop
    over rows)."""
    n_rows = csr.shape[0] if n_rows is None else int(n_rows)
    indptr = np.asarray(csr.indptr[: n_rows + 1], dtype=np.int64)
    degrees = np.diff(indptr)
    t_max = max(int(degrees.max()) if len(degrees) else 0, 1)
    out = np.full((n_rows, t_max), pad, np.int32)
    rows = np.repeat(np.arange(n_rows), degrees)
    cols = np.arange(len(rows)) - np.repeat(indptr[:-1] - indptr[0], degrees)
    out[rows, cols] = csr.indices[indptr[0]:indptr[-1]]
    return out


def _score_dtype(score_dtype):
    if score_dtype is None or score_dtype in ("float32", torch.float32):
        return torch.float32
    if score_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"score_dtype must be None, 'float32' or 'bfloat16'; got {score_dtype!r}")


def retrieval_topk(user_emb, item_table, k, exclude_list=None, mode="approx", score_dtype="bfloat16",
                   user_chunk=None, recall_target=0.95):
    """Top-k items per user over the full catalog (the serving fast path).

    Args:
        user_emb: (B, d) user representations.
        item_table: (n_items, d) item representations (dot-product scoring).
        k: results per user.
        exclude_list: optional (B, T) integer excluded item ids per user,
            padded with -1. Exclusion is exact: ``k + T`` candidates are
            taken, so the valid top k always survives the filter.
        mode: "approx" or "exact", accepted for the JAX signature only:
            both take the exact top k of the scores. The JAX package's
            "approx" reduces with ``lax.approx_max_k`` (the TPU's
            PartialReduce); PyTorch has no such reduce. The JAX package on
            a CPU does the same: there ``approx_max_k`` returns
            ``lax.top_k``'s ids. ``score_dtype`` alone changes the result.
        score_dtype: "bfloat16" (the default, as in the JAX package),
            "float32" or None (float32 scores).
        user_chunk: score the users in chunks of this size (bounds the
            score buffer to chunk x n_items); it must divide B.
        recall_target: accepted for the JAX signature only. The exact top
            k has recall 1, so every target in (0, 1] is met; a target
            outside it raises.

    Returns:
        (values (B, k) float32, indices (B, k) int64), descending, ties
        toward the lowest id; excluded or missing slots hold NEG_INF.
    """
    if mode not in ("approx", "exact"):
        raise ValueError(f"mode must be 'approx' or 'exact'; got {mode!r}")
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must lie in (0, 1]; got {recall_target!r}")
    dt = _score_dtype(score_dtype)
    B = user_emb.shape[0]
    items = item_table.to(dt)
    T = 0 if exclude_list is None else exclude_list.shape[1]
    kbuf = min(k + T, item_table.shape[0])

    def one(u_blk, ex):
        s = u_blk.to(dt) @ items.T
        val, idx = topk_lowest_index(s, kbuf)
        if ex is not None:
            hit = (idx[:, :, None] == ex[:, None, :]).any(-1)
            val = val.masked_fill(hit, NEG_INF)
        gv, gi = topk_lowest_index(val.float(), k)
        return gv, torch.gather(idx, 1, gi)

    if exclude_list is not None:
        exclude_list = torch.as_tensor(exclude_list, device=user_emb.device).long()
    if user_chunk is None or user_chunk >= B:
        return one(user_emb, exclude_list)
    if B % user_chunk:
        raise ValueError(f"user_chunk {user_chunk} must divide batch {B}")
    parts = [one(user_emb[s:s + user_chunk], None if exclude_list is None else exclude_list[s:s + user_chunk])
             for s in range(0, B, user_chunk)]
    return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])


def streaming_topk(user_emb, item_table, k, block=8192, exclude_mask=None):
    """Top-k items per user without forming all of a user's scores.

    Args:
        user_emb: (B, d) user representations.
        item_table: (n_items, d) item representations (dot-product scoring).
        k: results per user.
        block: items scored per step; the last block may be short.
        exclude_mask: optional (B, n_items) bool, True where excluded.

    Returns:
        (values (B, k), indices (B, k) int64), descending, in
        ``user_emb``'s dtype. As in the JAX package, each block's scores
        merge into a running (B, k) buffer that starts at NEG_INF with id 0,
        the buffer ahead of the block, ties toward the earlier entry; a user
        with fewer than k items left keeps NEG_INF rows with id 0.
    """
    B = user_emb.shape[0]
    n_items = item_table.shape[0]
    top_v = torch.full((B, k), NEG_INF, dtype=user_emb.dtype, device=user_emb.device)
    top_i = torch.zeros((B, k), dtype=torch.long, device=user_emb.device)
    for start in range(0, n_items, block):
        stop = min(start + block, n_items)
        scores = user_emb @ item_table[start:stop].T
        if exclude_mask is not None:
            scores = scores.masked_fill(exclude_mask[:, start:stop], NEG_INF)
        # The JAX package pads the last block with NEG_INF rows; those lose
        # every tie to the buffer, so a short last block gives the same ids.
        ids = torch.arange(start, stop, device=user_emb.device).expand(B, -1)
        new_v, sel = topk_lowest_index(torch.cat([top_v, scores], dim=1), k)
        top_i = torch.gather(torch.cat([top_i, ids], dim=1), 1, sel)
        top_v = new_v
    return top_v, top_i
