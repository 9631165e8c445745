"""The port's SGL augmentation and the host graph artifacts of SGL and LCFN
against the JAX package: ``sgl_augment`` on the same draws (kept nodes or
pairs) for aug_types 0, 1 and 2 on a graph with isolated nodes and on a
split's graph, its draws in distribution with A exactly symmetric,
``create_sgl_mat`` equal to JAX's arrays for one ``np.random`` seed, and
``get_graph_embeddings`` held to JAX's by the eigenvalues and the projectors
P P^T, Q Q^T (an eigenvector is free up to its sign and within a repeated
eigenvalue), two builds bit-equal and one result kept per data object."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_train_mf import structured_split

from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.ops import graph as jax_graph
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.ops.graph import sgl_augment, sgl_draws, undirected_pairs
from beta_recsys_tpu_torch.utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)

SSL_RATIO = 0.3


def symmetric_graph(n=50, n_edges=200, isolated=(0, 7, 23, 49), seed=0):
    """Both directions of random undirected edges without self-loops, in
    shuffled COO order; the ``isolated`` nodes have none."""
    rng = np.random.default_rng(seed)
    live = np.setdiff1d(np.arange(n), isolated)
    ends = rng.choice(live, (n_edges, 2))
    ends = ends[ends[:, 0] != ends[:, 1]]
    pairs = np.unique(np.concatenate([ends, ends[:, ::-1]]), axis=0)
    pairs = pairs[rng.permutation(len(pairs))]
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32), n


@pytest.fixture(scope="module")
def split_graph():
    data = BaseData(structured_split())
    rows, cols, _ = data.get_norm_adj("sym")
    return rows, cols, data.n_users + data.n_items


def _jax_augment(monkeypatch, rows, cols, n, aug_type, draws):
    """JAX ``sgl_augment`` with its uniform draws replaced by ``draws``: one
    a node (aug_type 0), else one an undirected pair in the order of the
    pairs' (min, max) ends, which is the order of their JAX pair ids."""
    if aug_type == 0:
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(draws))
    else:
        lo, hi = np.minimum(rows, cols).astype(np.int64), np.maximum(rows, cols).astype(np.int64)
        table = np.zeros(n * n, np.float32)
        table[np.unique(lo * n + hi)] = draws
        table = jnp.asarray(table)
        monkeypatch.setattr(jax.random, "fold_in", lambda key, data: data)  # the "key" is the pair id
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: table[key])
    out = jax_graph.sgl_augment(jax.random.key(0), jnp.asarray(rows), jnp.asarray(cols), n, aug_type, SSL_RATIO)
    return np.asarray(out)


@pytest.mark.parametrize("aug_type", [0, 1, 2])
@pytest.mark.parametrize("which", ["isolated", "split"])
def test_sgl_augment_on_the_same_draws_matches_jax(monkeypatch, split_graph, which, aug_type):
    rows, cols, n = symmetric_graph() if which == "isolated" else split_graph
    edge_pair, n_pairs = undirected_pairs(rows, cols)
    draws = np.random.default_rng(aug_type).uniform(size=n if aug_type == 0 else n_pairs).astype(np.float32)
    got = sgl_augment(torch.as_tensor(draws), torch.as_tensor(rows, dtype=torch.long),
                      torch.as_tensor(cols, dtype=torch.long), torch.as_tensor(edge_pair), n, aug_type, SSL_RATIO)
    want = _jax_augment(monkeypatch, rows, cols, n, aug_type, draws)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert 0 < int((got == 0).sum()) < len(rows)  # some edges dropped, some kept


def test_undirected_pairs_share_both_directions():
    rows, cols, _ = symmetric_graph()
    edge_pair, n_pairs = undirected_pairs(rows, cols)
    assert n_pairs == len(rows) // 2 and edge_pair.min() == 0 and edge_pair.max() == n_pairs - 1
    back = {(r, c): p for r, c, p in zip(rows, cols, edge_pair)}
    assert all(back[(c, r)] == p for (r, c), p in back.items())


@pytest.mark.parametrize("aug_type", [0, 1, 2])
def test_sgl_draws_in_distribution_keep_a_symmetric_graph(split_graph, aug_type):
    """Over 20 views: the kept share of the nodes (aug_type 0) or the pairs
    (1, 2) is 1 - ssl_ratio within 5 sigma; every view's A is exactly
    symmetric, its nonzero values 1 / sqrt(d_r d_c) of its own degrees."""
    rows, cols, n = split_graph
    edge_pair, n_pairs = undirected_pairs(rows, cols)
    rows_t, cols_t = torch.as_tensor(rows, dtype=torch.long), torch.as_tensor(cols, dtype=torch.long)
    gen = torch.Generator().manual_seed(0)
    kept = trials = 0
    for _ in range(20):
        draws = sgl_draws(gen, n if aug_type == 0 else n_pairs, "cpu")
        vals = sgl_augment(draws, rows_t, cols_t, torch.as_tensor(edge_pair), n, aug_type, SSL_RATIO)
        kept, trials = kept + int((draws >= SSL_RATIO).sum()), trials + draws.numel()
        a = torch.zeros(n, n)
        a[rows_t, cols_t] = vals
        assert torch.equal(a, a.T)
        deg = (a > 0).sum(dim=1).to(torch.float32)
        nz = vals > 0
        torch.testing.assert_close(vals[nz], (deg[rows_t] * deg[cols_t]).rsqrt()[nz], rtol=1e-6, atol=0)
    keep = 1 - SSL_RATIO
    assert abs(kept - keep * trials) < 5 * np.sqrt(trials * keep * (1 - keep))


def _frames(seed=0, n_users=60, n_items=40, n_rows=500):
    """A train frame of random distinct (user, item) pairs (ids from 1)."""
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(0, n_users, n_rows), rng.integers(0, n_items, n_rows)], 1), axis=0)
    pairs = pairs[rng.permutation(len(pairs))]
    train = {DEFAULT_USER_COL: pairs[:, 0] + 1, DEFAULT_ITEM_COL: pairs[:, 1] + 1,
             DEFAULT_RATING_COL: np.ones(len(pairs), np.float32), DEFAULT_TIMESTAMP_COL: np.arange(len(pairs))}
    return BaseData((train, [], [])), JaxBaseData((pd.DataFrame(train), [], []))


@pytest.mark.parametrize("aug_type,ssl_ratio,is_subgraph", [(0, 0.1, True), (1, 0.1, True), (2, 0.25, True),
                                                            (1, 0.1, False), (1, 0.0, True)])
def test_create_sgl_mat_equals_jax(aug_type, ssl_ratio, is_subgraph):
    ours, ref = _frames()
    got = ours.create_sgl_mat(aug_type, ssl_ratio, is_subgraph, rng=np.random.default_rng(3))
    want = ref.create_sgl_mat(aug_type, ssl_ratio, is_subgraph, rng=np.random.default_rng(3))
    for g, w, dtype in zip(got, want, (np.int32, np.int32, np.float32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tol", [1e-5, 1e-9])
def test_graph_embeddings_match_jax_by_eigenvalues_and_projectors(tol):
    ours, ref = _frames()
    got, want = ours.get_graph_embeddings(0.2, tol), ref.get_graph_embeddings(0.2, tol)
    for g, w, lap, n in zip(got, want, ours.hypergraph_laplacians(), (ours.n_users, ours.n_items)):
        assert g.dtype == np.float32 and g.shape == w.shape == (n, int(0.2 * n))
        np.testing.assert_allclose(g.T @ g, np.eye(g.shape[1]), atol=1e-5)
        eig_got, eig_want = np.diag(g.T @ (lap @ g)), np.diag(w.T @ (lap @ w))
        np.testing.assert_allclose(np.sort(eig_got), np.sort(eig_want), rtol=0, atol=1e-6)
        np.testing.assert_allclose(g @ g.T, w @ w.T, rtol=0, atol=1e-5)
        dense = lap.toarray()
        assert np.allclose(np.linalg.eigvalsh(dense)[: g.shape[1]], np.sort(eig_got), atol=1e-6)


def test_graph_embeddings_repeat_bit_for_bit_and_are_kept_per_data():
    first, _ = _frames()
    again, _ = _frames()
    p1, q1 = first.get_graph_embeddings(0.2)
    p2, q2 = again.get_graph_embeddings(0.2)
    assert np.array_equal(p1, p2) and np.array_equal(q1, q2)
    assert first.get_graph_embeddings(0.2) is first.get_graph_embeddings(0.2, 1e-5)
    p3, _ = first.get_graph_embeddings(0.1)
    assert p3.shape == (first.n_users, int(0.1 * first.n_users))
