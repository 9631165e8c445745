"""Dense re-indexing of a split and the arrays evaluation and serving need.

Counterpart of ``BaseData`` in ``beta_recsys_tpu/data/base_data.py``, on
numpy + scipy frames (dicts of columns, see ``utils/common.py``) in
place of pandas. It keeps the reference's semantics exactly:

- with ``intersect`` (the default), valid/test rows whose user or item
  never occurs in train are dropped; without it they stay, and their ids,
  which have no dense id, become NaN in float64 id columns, as pandas'
  ``map`` leaves them;
- with ``binarize`` (the default), ratings ``> bin_thld`` become 1, the
  others keep their value;
- with ``normalize``, ratings (after binarizing) are divided by the largest
  train rating;
- users and items get dense ids in order of FIRST APPEARANCE in train (as
  ``pd.Series.unique`` gives them), not in sorted order.

The graph artifacts (``create_adj_mat``, ``get_adj_mat``, ``get_norm_adj``)
are the JAX package's scipy constructions over the (users + items) node
graph, with the same arrays in the same order; ``create_constraint_mat`` is
UltraGCN's degree vectors, ``create_sgl_mat`` SGL's host-side augmented
adjacency and ``get_graph_embeddings`` LCFN's hypergraph-Laplacian
eigenvectors, as the JAX package computes them (the eigenvectors from a
fixed ARPACK start, kept per data object).
"""

import os
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp

from ..utils.common import normalized_adj_single
from ..utils.constants import DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_USER_COL


class TrainArrays(NamedTuple):
    """Train interactions as flat arrays (int32 dense ids, float32 ratings)."""

    users: np.ndarray
    items: np.ndarray
    ratings: np.ndarray


class EvalCandidates(NamedTuple):
    """Padded per-user candidate sets for ranked evaluation.

    users:     (U,)  int32 — dense user ids with >=1 relevant candidate.
    items:     (U, C) int32 — candidate item ids, padded with 0.
    relevance: (U, C) float32 — 1.0 where the candidate is a positive.
    ratings:   (U, C) float32 — raw ratings.
    mask:      (U, C) bool — valid candidate slots.
    """

    users: np.ndarray
    items: np.ndarray
    relevance: np.ndarray
    ratings: np.ndarray
    mask: np.ndarray


def first_appearance_unique(values):
    """Distinct values in order of first appearance (``pd.Series.unique``)."""
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def _dense_ids(values, pool):
    """Position of each value in ``pool`` as int64; where some value is not
    in it, float64 positions with NaN there (pandas' ``map`` of a missing
    key)."""
    order = np.argsort(pool, kind="stable")
    pos = np.searchsorted(pool, values, sorter=order)
    found = order[np.minimum(pos, len(pool) - 1)] if len(pool) else np.zeros(len(values), np.int64)
    seen = (pool[found] == values) if len(pool) else np.zeros(len(values), bool)
    if seen.all():
        return found.astype(np.int64)
    return np.where(seen, found, np.nan)


class BaseData:
    """A split re-indexed to dense ids, with the arrays scoring needs."""

    def __init__(self, split_dataset, intersect=True, binarize=True, bin_thld=0.0, normalize=False):
        train, valid, test = split_dataset
        valid = [valid] if isinstance(valid, dict) else list(valid)
        test = [test] if isinstance(test, dict) else list(test)
        self.user_pool = first_appearance_unique(train[DEFAULT_USER_COL])
        self.item_pool = first_appearance_unique(train[DEFAULT_ITEM_COL])
        self.n_users = len(self.user_pool)
        self.n_items = len(self.item_pool)
        if intersect:
            valid, test = [self._intersect(f) for f in valid], [self._intersect(f) for f in test]
        # Copies throughout: the caller's frames are never modified.
        frames = [dict(f) for f in (train, *valid, *test)]
        for f in frames:
            f[DEFAULT_RATING_COL] = np.array(f[DEFAULT_RATING_COL])
            if binarize:
                f[DEFAULT_RATING_COL][f[DEFAULT_RATING_COL] > bin_thld] = 1.0
        if normalize:
            max_rating = frames[0][DEFAULT_RATING_COL].max()
            assert max_rating > 0, "All ratings may be <= 0."
            for f in frames:
                f[DEFAULT_RATING_COL] = f[DEFAULT_RATING_COL] / max_rating
        for f in frames:
            f[DEFAULT_USER_COL] = _dense_ids(f[DEFAULT_USER_COL], self.user_pool)
            f[DEFAULT_ITEM_COL] = _dense_ids(f[DEFAULT_ITEM_COL], self.item_pool)
        self.train = frames[0]
        self.valid = frames[1:1 + len(valid)]
        self.test = frames[1 + len(valid):]
        self._pos_csr_cache = None
        self._graph_embeddings_cache = {}

    def _intersect(self, frame):
        """Drop rows whose user or item is unseen in train."""
        keep = np.isin(frame[DEFAULT_USER_COL], self.user_pool) & np.isin(
            frame[DEFAULT_ITEM_COL], self.item_pool
        )
        return {col: values[keep] for col, values in frame.items()}

    def train_arrays(self):
        """Train interactions as flat arrays, for the trainers."""
        return TrainArrays(
            users=self.train[DEFAULT_USER_COL].astype(np.int32),
            items=self.train[DEFAULT_ITEM_COL].astype(np.int32),
            ratings=self.train[DEFAULT_RATING_COL].astype(np.float32),
        )

    def pos_csr(self):
        """Per-user sorted positive items as CSR (indptr, items), int32: the
        train pairs lexsorted by (user, item). Feeds the rejection sampler's
        membership test (``ops/sampling.make_membership_test``)."""
        if self._pos_csr_cache is None:
            users = self.train[DEFAULT_USER_COL].astype(np.int64)
            items = self.train[DEFAULT_ITEM_COL].astype(np.int64)
            order = np.lexsort((items, users))
            counts = np.bincount(users, minlength=self.n_users)
            indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
            self._pos_csr_cache = (indptr, items[order].astype(np.int32))
        return self._pos_csr_cache

    def pos_bitmask(self):
        """Dense (n_users, n_items) bool positive mask (small catalogs only)."""
        mask = np.zeros((self.n_users, self.n_items), dtype=bool)
        mask[self.train[DEFAULT_USER_COL], self.train[DEFAULT_ITEM_COL]] = True
        return mask

    def user_item_csr(self):
        """Binarized user x item train interactions as scipy CSR."""
        return sp.csr_matrix(
            (
                self.train[DEFAULT_RATING_COL].astype(np.float32),
                (self.train[DEFAULT_USER_COL], self.train[DEFAULT_ITEM_COL]),
            ),
            shape=(self.n_users, self.n_items),
        )

    def eval_candidates(self, frame, pad_to=None):
        """Padded candidate arrays of an evaluation frame.

        Only users with at least one relevant (rating >= 1) candidate are
        kept; each user's candidates keep their frame order in the slots
        (the ranking breaks ties by slot).
        """
        users = frame[DEFAULT_USER_COL]
        keep = np.isin(users, users[frame[DEFAULT_RATING_COL] >= 1])
        users = users[keep]
        uniq_users, user_idx = np.unique(users, return_inverse=True)
        n_u = len(uniq_users)
        order = np.argsort(user_idx, kind="stable")
        counts = np.bincount(user_idx, minlength=n_u)
        slot = np.empty(len(users), dtype=np.int64)
        slot[order] = np.arange(len(users)) - np.repeat(np.cumsum(counts) - counts, counts)
        C = pad_to or (int(counts.max()) if n_u else 0)

        items = np.zeros((n_u, C), dtype=np.int32)
        ratings = np.zeros((n_u, C), dtype=np.float32)
        mask = np.zeros((n_u, C), dtype=bool)
        items[user_idx, slot] = frame[DEFAULT_ITEM_COL][keep]
        ratings[user_idx, slot] = frame[DEFAULT_RATING_COL][keep]
        mask[user_idx, slot] = True
        relevance = (ratings >= 1).astype(np.float32) * mask
        return EvalCandidates(
            users=uniq_users.astype(np.int32),
            items=items,
            relevance=relevance,
            ratings=ratings,
            mask=mask,
        )

    # -- graph artifacts -----------------------------------------------------------

    def _bipartite(self):
        """Binarized symmetric adjacency [[0, R], [R^T, 0]] over the n_users +
        n_items nodes (items after users) as scipy CSR; duplicate train pairs
        count once."""
        n = self.n_users + self.n_items
        u = self.train[DEFAULT_USER_COL].astype(np.int64)
        i = self.train[DEFAULT_ITEM_COL].astype(np.int64) + self.n_users
        upper = sp.csr_matrix((np.ones(len(u), dtype=np.float32), (u, i)), shape=(n, n))
        upper.data[:] = 1.0
        return upper + upper.T

    def create_adj_mat(self):
        """(A, D^-1 (A + I), D^-1 A) as scipy CSR, each row-normalized by its
        own degrees (JAX ``create_adj_mat``, ``data/base_data.py:232-246``)."""
        adj = self._bipartite()
        norm_adj = normalized_adj_single(adj + sp.eye(adj.shape[0], dtype=np.float32))
        mean_adj = normalized_adj_single(adj)
        return adj.tocsr(), norm_adj.tocsr(), mean_adj.tocsr()

    def get_adj_mat(self, config=None, cache_dir=None):
        """``create_adj_mat``'s triple, cached as ``ngcf_<dataset>_<split>_adj.npz``
        under ``cache_dir``, else under the config's ``system.process_dir``
        (then ``dataset.data_dir``, then "."); built in memory without either
        (JAX ``get_adj_mat``, ``data/base_data.py:248-289``, the same file)."""
        path = None
        if cache_dir is not None or config is not None:
            system = config["system"] if config is not None and "system" in config else {}
            dataset = config["dataset"] if config is not None and "dataset" in config else {}
            if cache_dir is None:
                cache_dir = system.get("process_dir") or dataset.get("data_dir") or "."
            tag = f"ngcf_{dataset.get('dataset', 'data')}_{dataset.get('data_split', 'split')}"
            path = os.path.join(cache_dir, tag + "_adj.npz")
        n = self.n_users + self.n_items
        if path is not None and os.path.exists(path):
            with np.load(path, allow_pickle=False) as z:
                return tuple(
                    sp.csr_matrix((z[f"{p}_data"], z[f"{p}_indices"], z[f"{p}_indptr"]), shape=(n, n))
                    for p in ("adj", "norm", "mean")
                )
        mats = self.create_adj_mat()
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            np.savez(path, **{f"{p}_{field}": getattr(m, field) for p, m in zip(("adj", "norm", "mean"), mats)
                              for field in ("data", "indices", "indptr")})
        return mats

    def get_norm_adj(self, variant="sym"):
        """The normalized adjacency as COO arrays (rows, cols, vals),
        int32/int32/float32, in the JAX package's order (scipy's COO of A's
        CSR): "sym" D^-1/2 A D^-1/2, "row" D^-1 A, "row_selfloop" D^-1 (A + I)
        with the degrees of A + I (JAX ``get_norm_adj``,
        ``data/base_data.py:333-366``)."""
        bip = self._bipartite()
        if variant == "row_selfloop":
            bip = (bip + sp.eye(bip.shape[0], dtype=np.float32, format="csr")).tocsr()
        adj = bip.tocoo()
        deg = np.asarray(adj.sum(axis=1)).flatten()
        if variant == "sym":
            d_inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
            vals = d_inv_sqrt[adj.row] * adj.data * d_inv_sqrt[adj.col]
        elif variant in ("row", "row_selfloop"):
            d_inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
            vals = d_inv[adj.row] * adj.data
        else:
            raise ValueError(f"Unknown variant {variant}")
        return adj.row.astype(np.int32), adj.col.astype(np.int32), vals.astype(np.float32)

    def create_constraint_mat(self):
        """UltraGCN's (train_mat, beta_uD, beta_iD): the binarized user x item
        CSR, sqrt(d_u + 1) / d_u (0 for a user of degree 0) and 1 / sqrt(d_i
        + 1), float32 (JAX ``create_constraint_mat``,
        ``data/base_data.py:368-382``)."""
        train_mat = self.user_item_csr()
        train_mat.data[:] = 1.0
        items_d = np.asarray(train_mat.sum(axis=0)).flatten()
        users_d = np.asarray(train_mat.sum(axis=1)).flatten()
        with np.errstate(divide="ignore", invalid="ignore"):
            beta_ud = np.sqrt(users_d + 1) / users_d
        beta_ud[~np.isfinite(beta_ud)] = 0.0
        beta_id = 1.0 / np.sqrt(items_d + 1)
        return train_mat, beta_ud.astype(np.float32), beta_id.astype(np.float32)

    def create_sgl_mat(self, aug_type=1, ssl_ratio=0.1, is_subgraph=True, rng=None):
        """SGL's augmented sym-normalized adjacency as COO arrays (rows, cols,
        vals): aug_type 0 drops ``ssl_ratio`` of the users and of the items,
        1 and 2 keep ``1 - ssl_ratio`` of the train rows, drawn by ``rng``
        (a ``np.random.Generator``) with the JAX package's ``choice`` calls in
        its order (JAX ``create_sgl_mat``, ``data/base_data.py:384-422``)."""
        rng = rng or np.random.default_rng()
        n = self.n_users + self.n_items
        user_np = self.train[DEFAULT_USER_COL].astype(np.int64)
        item_np = self.train[DEFAULT_ITEM_COL].astype(np.int64)
        if is_subgraph and aug_type in (0, 1, 2) and ssl_ratio > 0:
            if aug_type == 0:
                keep_user = np.ones(self.n_users, dtype=bool)
                keep_item = np.ones(self.n_items, dtype=bool)
                keep_user[rng.choice(self.n_users, size=int(self.n_users * ssl_ratio), replace=False)] = False
                keep_item[rng.choice(self.n_items, size=int(self.n_items * ssl_ratio), replace=False)] = False
                keep = keep_user[user_np] & keep_item[item_np]
                u_keep, i_keep = user_np[keep], item_np[keep]
            else:
                keep_idx = rng.choice(len(user_np), size=int(len(user_np) * (1 - ssl_ratio)), replace=False)
                u_keep, i_keep = user_np[keep_idx], item_np[keep_idx]
        else:
            u_keep, i_keep = user_np, item_np
        ones = np.ones(len(u_keep), dtype=np.float32)
        upper = sp.csr_matrix((ones, (u_keep, i_keep + self.n_users)), shape=(n, n))
        adj = (upper + upper.T).tocoo()
        deg = np.asarray(adj.sum(axis=1)).flatten()
        d_inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
        vals = d_inv_sqrt[adj.row] * adj.data * d_inv_sqrt[adj.col]
        return adj.row.astype(np.int32), adj.col.astype(np.int32), vals.astype(np.float32)

    def hypergraph_laplacians(self):
        """LCFN's (L_u, L_v) as scipy sparse matrices: I - D_n^-1/2 H D_e^-1
        H^T D_n^-1/2 over the users (items as hyperedges) and the same over
        the items, H the binarized train matrix, degrees floored at 1e-10."""
        eps = 1e-10
        h = self.user_item_csr()
        h.data[:] = 1.0
        d_u = np.asarray(h.sum(axis=1)).flatten()
        d_v = np.asarray(h.sum(axis=0)).flatten()
        dn_u = sp.diags(1.0 / np.maximum(np.sqrt(d_u), eps))
        de_v = sp.diags(1.0 / np.maximum(d_v, eps))
        l_u = sp.eye(self.n_users) - dn_u @ h @ de_v @ h.T @ dn_u
        dn_v = sp.diags(1.0 / np.maximum(np.sqrt(d_v), eps))
        de_u = sp.diags(1.0 / np.maximum(d_u, eps))
        l_v = sp.eye(self.n_items) - dn_v @ h.T @ de_u @ h @ dn_v
        return l_u, l_v

    def get_graph_embeddings(self, cut_off=0.2, tol=1e-5):
        """LCFN's (P, Q), float32: the eigenvectors of the smallest
        max(int(cut_off * n), 1) eigenvalues of each hypergraph Laplacian
        (``scipy.sparse.linalg.eigsh(which="SM")``, JAX
        ``get_graph_embeddings``, ``data/base_data.py:424-454``). ARPACK
        starts from U(-1, 1) draws of ``np.random.default_rng(0)``, not from a
        fresh random vector, so two calls give the same bits (an eigenvector
        is free up to its sign, and the JAX package's call to call). One
        result is kept per (cut_off, tol)."""
        key = (float(cut_off), float(tol))
        if key not in self._graph_embeddings_cache:
            from scipy.sparse.linalg import eigsh

            out = []
            for lap, n in zip(self.hypergraph_laplacians(), (self.n_users, self.n_items)):
                v0 = np.random.default_rng(0).uniform(-1.0, 1.0, n)
                _, vecs = eigsh(lap.tocsc(), k=max(int(cut_off * n), 1), which="SM", tol=tol, v0=v0)
                out.append(vecs.astype(np.float32))
            self._graph_embeddings_cache[key] = tuple(out)
        return self._graph_embeddings_cache[key]
