"""Least device times from shapes: the larger of the bytes that must move
over the HBM rate and the operations over the peak rate. Frozen copies of
``chip_smoke.py``'s ``attention_bound``, ``attention_bwd_bound`` and
``rowadam_bound``, and of ``bench.py``'s ``_sasrec_flops`` arithmetic
(the attention counted over the causal half of the pairs, which is all the
model needs). Each returns (seconds, "bytes" or "operations")."""

from arith.peaks import FLOPS, HBM_BYTES_PER_S

_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def _bound(nbytes, flops, dtype="float32"):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FLOPS[dtype]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def attention_fwd(n, t, dh, dtype="float32"):
    """Causal flash forward over (n, t, dh): q, k, v read once, out and the
    row log-sum-exp written once; 4 * dh FLOPs a visible (query, key) pair."""
    return _bound(n * t * (4 * dh * _ITEMSIZE[dtype] + 4), 4 * dh * n * t * (t + 1) // 2, dtype)


def attention_bwd(n, t, dh, dtype="float32"):
    """Its backward: q, k, v, dout and lse read once, dq, dk, dv written
    once; ~10 * dh FLOPs a visible pair (q.k and dout.v again, and the
    products into dq, dk and dv)."""
    return _bound(n * t * (7 * dh * _ITEMSIZE[dtype] + 4), 10 * dh * n * t * (t + 1) // 2, dtype)


def rowadam(tables, d):
    """One lazy-Adam write of several float32 tables of width d in one
    launch; ``tables`` lists (touched rows, ids) a table. A touched row
    reads table, m, v and its gradient row and writes table, m and v (7
    rows); every id (8 bytes) is read once; 12 FLOPs a touched element."""
    touched = sum(t for t, _ in tables)
    ids = sum(i for _, i in tables)
    return _bound(touched * 7 * d * 4 + ids * 8, 12 * touched * d)


def pairwise_step(batch, touched, d):
    """One lazy-Adam BPR step of a factorization model: the batch's user,
    positive and negative rows read (3B rows of d float32, 3B ids of 8
    bytes), each touched row's parameter and two moments read and written;
    FLOPs: the two dot products a pair forward (4d) and twice that
    backward, and 12 a touched element for Adam."""
    nbytes = 4 * d * (3 * batch + 6 * touched) + 8 * 3 * batch
    return _bound(nbytes, 3 * 4 * d * batch + 12 * touched * d)


def flops_only(flops, dtype="float32"):
    return _bound(0, flops, dtype)
