"""ctypes bindings of the host library for the offline data pipeline.

Counterpart of ``beta_recsys_tpu/native/__init__.py``. ``csrc/host/
betarec_host.cc`` (alias tables, per-user negative draws, the k-core
filters) is built with one ``g++`` call at first use into ``build/
torch_host/`` at the root of the checkout (listed in ``.gitignore``), under a
name that carries the hash of the source and the flags, and loaded with
ctypes. A failed build raises: nothing falls back to numpy in silence. Each
entry point's numpy version (``*_numpy``) stands beside it as its plain
version, and the pipeline takes it when the caller passes
``use_native=False``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "betarec_host.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_host"
# No -march=native: the library must draw and filter the same on every host,
# and floating-point contraction stays off.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")


def library_path():
    """Where the library goes, keyed by the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libbetarec_host_{digest.hexdigest()[:16]}.so"


def build():
    """Build the library with g++ if it is stale. Returns (path, seconds);
    seconds are 0 when it was already built. Raises with g++'s output if
    the build fails."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the host library of the data pipeline cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, time.perf_counter() - t0


@functools.cache
def library():
    """The ctypes handle, built if stale."""
    lib = ctypes.CDLL(str(build()[0]))
    lib.alias_build.restype = None
    lib.alias_sample.restype = None
    lib.feed_neg_batch.restype = ctypes.c_int
    lib.kcore_filter.restype = None
    lib.kcore_filter_distinct.restype = None
    return lib


class InsufficientNegatives(RuntimeError):
    """A user has fewer distinct negatives than the draw asks for."""


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _i64(x):
    return np.ascontiguousarray(x, dtype=np.int64)


def alias_build(freqs):
    """(prob, alias) of Walker's alias table over ``freqs``."""
    freqs = np.ascontiguousarray(freqs, dtype=np.float64)
    n = len(freqs)
    prob, alias = np.empty(n, np.float64), np.empty(n, np.int64)
    library().alias_build(_ptr(freqs, ctypes.c_double), ctypes.c_int64(n), _ptr(prob, ctypes.c_double),
                          _ptr(alias, ctypes.c_int64))
    return prob, alias


def alias_sample(prob, alias, count, seed=0):
    """``count`` table indices drawn with replacement (``std::mt19937_64``)."""
    prob, alias = np.ascontiguousarray(prob, dtype=np.float64), _i64(alias)
    out = np.empty(count, np.int64)
    library().alias_sample(_ptr(prob, ctypes.c_double), _ptr(alias, ctypes.c_int64), ctypes.c_int64(len(prob)),
                           ctypes.c_int64(count), ctypes.c_uint64(seed), _ptr(out, ctypes.c_int64))
    return out


def alias_sample_numpy(prob, alias, count, seed=0):
    """The plain version of ``alias_sample`` (numpy's generator: other draws)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(prob), size=count)
    return np.where(rng.random(count) < np.asarray(prob)[idx], idx, np.asarray(alias)[idx])


def feed_neg_batch(indptr, pos_items, prob, alias, labels, n_negative, seed=0):
    """(n_users, n_negative) distinct negatives a user, drawn from the alias
    table and rejected against the user's positives (CSR ``indptr`` /
    ``pos_items``). Raises when a user cannot get enough of them."""
    indptr, pos_items, alias, labels = _i64(indptr), _i64(pos_items), _i64(alias), _i64(labels)
    prob = np.ascontiguousarray(prob, dtype=np.float64)
    n_users = len(indptr) - 1
    out = np.empty((n_users, n_negative), np.int64)
    rc = library().feed_neg_batch(
        _ptr(indptr, ctypes.c_int64), _ptr(pos_items, ctypes.c_int64), ctypes.c_int64(n_users),
        _ptr(prob, ctypes.c_double), _ptr(alias, ctypes.c_int64), _ptr(labels, ctypes.c_int64),
        ctypes.c_int64(len(prob)), ctypes.c_int64(n_negative), ctypes.c_uint64(seed), _ptr(out, ctypes.c_int64))
    if rc != 0:
        raise InsufficientNegatives("Insufficient distinct negative items for sampling")
    return out


def feed_neg_batch_numpy(indptr, pos_items, prob, alias, labels, n_negative, seed=0):
    """The plain version of ``feed_neg_batch``: the same rejection rule on
    numpy's generator (other draws), bounded as the C++ loop is."""
    prob, alias, labels = np.asarray(prob), np.asarray(alias), np.asarray(labels)
    rng = np.random.default_rng(seed)
    out = np.empty((len(indptr) - 1, n_negative), np.int64)
    max_attempts = 100 * (n_negative + 1) + 16 * len(prob)
    for u in range(len(indptr) - 1):
        pos = set(np.asarray(pos_items[indptr[u]:indptr[u + 1]]).tolist())
        got, seen, attempts = [], set(), 0
        while len(got) < n_negative:
            attempts += 1
            if attempts > max_attempts:
                raise InsufficientNegatives("Insufficient distinct negative items for sampling")
            idx = rng.integers(0, len(prob), size=n_negative * 2)
            draws = labels[np.where(rng.random(len(idx)) < prob[idx], idx, alias[idx])]
            for d in draws.tolist():
                if d not in pos and d not in seen:
                    seen.add(d)
                    got.append(d)
                    if len(got) == n_negative:
                        break
        out[u] = got
    return out


def kcore_filter(users, items, n_users, n_items, min_u_c, min_i_c):
    """Surviving-row mask of the iterative k-core over row counts."""
    users, items = _i64(users), _i64(items)
    keep = np.empty(len(users), np.uint8)
    library().kcore_filter(_ptr(users, ctypes.c_int64), _ptr(items, ctypes.c_int64), ctypes.c_int64(len(users)),
                           ctypes.c_int64(n_users), ctypes.c_int64(n_items), ctypes.c_int64(min_u_c),
                           ctypes.c_int64(min_i_c), _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool)


def kcore_filter_numpy(users, items, n_users, n_items, min_u_c, min_i_c):
    """The plain version of ``kcore_filter``."""
    users, items = _i64(users), _i64(items)
    keep = np.ones(len(users), bool)
    while True:
        u_deg = np.bincount(users[keep], minlength=n_users)
        i_deg = np.bincount(items[keep], minlength=n_items)
        drop = keep & (((min_i_c > 0) & (u_deg[users] < min_i_c)) | ((min_u_c > 0) & (i_deg[items] < min_u_c)))
        if not drop.any():
            return keep
        keep &= ~drop


def kcore_filter_distinct(users, items, pair_ids, uo_ids, n_users, n_items, n_pairs, n_uos, min_u_c, min_i_c,
                          min_o_c=0):
    """Surviving-row mask of the k-core over DISTINCT counts (pandas'
    ``nunique``): users need ``min_i_c`` distinct items (and, with
    ``uo_ids``, ``min_o_c`` distinct orders), items ``min_u_c`` distinct
    users. ``pair_ids`` / ``uo_ids`` factorize (user, item) and (user,
    order); ``uo_ids`` is None when ``min_o_c`` is 0."""
    users, items, pair_ids = _i64(users), _i64(items), _i64(pair_ids)
    has_orders = uo_ids is not None and min_o_c > 0
    uo = _i64(uo_ids) if has_orders else None
    keep = np.empty(len(users), np.uint8)
    library().kcore_filter_distinct(
        _ptr(users, ctypes.c_int64), _ptr(items, ctypes.c_int64), _ptr(pair_ids, ctypes.c_int64),
        _ptr(uo, ctypes.c_int64) if has_orders else None, ctypes.c_int64(len(users)), ctypes.c_int64(n_users),
        ctypes.c_int64(n_items), ctypes.c_int64(n_pairs), ctypes.c_int64(n_uos if has_orders else 0),
        ctypes.c_int64(min_u_c), ctypes.c_int64(min_i_c), ctypes.c_int64(min_o_c if has_orders else 0),
        _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool)


def kcore_filter_distinct_numpy(users, items, pair_ids, uo_ids, n_users, n_items, n_pairs, n_uos, min_u_c,
                                min_i_c, min_o_c=0):
    """The plain version of ``kcore_filter_distinct``: every round drops, at
    once, the rows of each user or item under its distinct count."""
    users, items, pair_ids = _i64(users), _i64(items), _i64(pair_ids)
    has_orders = uo_ids is not None and min_o_c > 0
    keep = np.ones(len(users), bool)

    def distinct(ids, owners, n_ids, n_owners):
        alive = np.flatnonzero(keep)
        groups = np.unique(ids[alive])
        rep = np.zeros(n_ids, np.int64)
        rep[ids[alive]] = alive  # any row of a group names its owner
        return np.bincount(owners[rep[groups]], minlength=n_owners)

    while True:
        user_items = distinct(pair_ids, users, n_pairs, n_users)
        item_users = distinct(pair_ids, items, n_pairs, n_items)
        drop = keep & (((min_i_c > 0) & (user_items[users] < min_i_c))
                       | ((min_u_c > 0) & (item_users[items] < min_u_c)))
        if has_orders:
            drop |= keep & (distinct(_i64(uo_ids), users, n_uos, n_users)[users] < min_o_c)
        if not drop.any():
            return keep
        keep &= ~drop
