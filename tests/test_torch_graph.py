"""The port's graph layer against the JAX package on the same inputs: the
adjacency artifacts of ``BaseData`` (``get_norm_adj`` in all three variants,
``create_adj_mat``, ``get_adj_mat`` and its cache), the dense and sparse
propagators (forward and x-gradient, with the packed and with per-step edge
values) against the JAX dense, COO and chunked propagators, on a graph with
isolated nodes and on a split's graph, the plain ``spmm_coo``,
layer-averaged propagation, and edge dropout in distribution."""

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
from beta_recsys_tpu_torch.ops.graph import (
    CsrPropagator,
    DensePropagator,
    edge_dropout,
    pack_propagator,
    propagate_mean,
    spmm_coo,
)

# float32 sums of a few hundred terms in other orders on the two sides.
RTOL, ATOL = 1e-5, 1e-6
JAX_PROPAGATORS = {"dense": jax_graph.DensePropagator, "coo": jax_graph.CooPropagator,
                   "chunked": jax_graph.ChunkedPropagator}


@pytest.fixture(scope="module")
def both_data():
    train, valid, test = structured_split()
    return BaseData((train, valid, test)), JaxBaseData((pd.DataFrame(train), [pd.DataFrame(f) for f in valid],
                                                        [pd.DataFrame(f) for f in test]))


def isolated_graph(n=50, n_edges=300, isolated=(0, 7, 23, 49), seed=0):
    """Unique (row, col) pairs with random weights, in shuffled COO order;
    the ``isolated`` nodes have no edge either way."""
    rng = np.random.default_rng(seed)
    live = np.setdiff1d(np.arange(n), isolated)
    pairs = np.unique(rng.choice(live, (n_edges, 2)), axis=0)
    pairs = pairs[rng.permutation(len(pairs))]
    vals = rng.uniform(0.05, 1.0, len(pairs)).astype(np.float32)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32), vals, n


@pytest.fixture(scope="module", params=["isolated", "split"])
def graph(request, both_data):
    if request.param == "isolated":
        return isolated_graph()
    data = both_data[0]
    return (*data.get_norm_adj("row_selfloop"), data.n_users + data.n_items)


@pytest.mark.parametrize("variant", ["sym", "row", "row_selfloop"])
def test_norm_adj_equals_jax(both_data, variant):
    ours, ref = both_data
    got, want = ours.get_norm_adj(variant), ref.get_norm_adj(variant)
    for g, w, dtype in zip(got, want, (np.int32, np.int32, np.float32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="Unknown variant"):
        ours.get_norm_adj("col")


def _same_csr(got, want):
    assert got.format == want.format == "csr" and got.shape == want.shape
    for field in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_adj_mats_equal_jax_and_the_cache_reads_both_ways(both_data, tmp_path):
    ours, ref = both_data
    for got, want in zip(ours.create_adj_mat(), ref.create_adj_mat()):
        _same_csr(got, want)
    cfg = {"system": {"process_dir": str(tmp_path)}, "dataset": {"dataset": "syn", "data_split": "loo"}}
    first = ours.get_adj_mat(cfg)
    assert (tmp_path / "ngcf_syn_loo_adj.npz").exists()
    for built, cached, jax_cached in zip(first, ours.get_adj_mat(cfg), ref.get_adj_mat(cfg)):
        _same_csr(cached, built)
        _same_csr(jax_cached, built)
    for got, want in zip(ours.get_adj_mat(cache_dir=str(tmp_path / "other")), first):
        _same_csr(got, want)
    assert (tmp_path / "other" / "ngcf_data_split_adj.npz").exists()


def _dropped(vals, seed=1, keep=0.6):
    mask = np.random.default_rng(seed).uniform(size=vals.shape) < keep
    return np.where(mask, vals / keep, 0.0).astype(np.float32)


@pytest.mark.parametrize("per_step", [False, True], ids=["packed", "per-step"])
@pytest.mark.parametrize("jax_fmt", list(JAX_PROPAGATORS))
@pytest.mark.parametrize("fmt", ["dense", "chunked"])
def test_propagation_and_x_gradient_match_jax(graph, fmt, jax_fmt, per_step):
    rows, cols, vals, n = graph
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    g = rng.standard_normal((n, 16)).astype(np.float32)
    step_vals = _dropped(vals) if per_step else None

    ref = JAX_PROPAGATORS[jax_fmt](rows, cols, vals, n)
    jax_vals = None if step_vals is None else jnp.asarray(step_vals)
    want_out = ref.spmm(jnp.asarray(x), jax_vals)
    want_grad = jax.grad(lambda x_: jnp.sum(ref.spmm(x_, jax_vals) * g))(jnp.asarray(x))

    prop = pack_propagator(rows, cols, vals, n, fmt=fmt, device="cpu")
    assert isinstance(prop, DensePropagator if fmt == "dense" else CsrPropagator)
    xt = torch.tensor(x, requires_grad=True)
    out = prop.spmm(xt, None if step_vals is None else torch.as_tensor(step_vals))
    (out * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)
    if graph[3] == 50:  # the isolated nodes receive nothing and pass no gradient on
        assert not out.detach()[[0, 7, 23, 49]].any() and not xt.grad[[0, 7, 23, 49]].any()


def test_spmm_coo_matches_jax(graph):
    rows, cols, vals, n = graph
    x = np.random.default_rng(3).standard_normal((n, 8)).astype(np.float32)
    got = spmm_coo(torch.as_tensor(rows, dtype=torch.long), torch.as_tensor(cols, dtype=torch.long),
                   torch.as_tensor(vals), torch.as_tensor(x))
    want = jax_graph.spmm_coo(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("per_step", [False, True], ids=["packed", "per-step"])
@pytest.mark.parametrize("fmt", ["dense", "chunked"])
def test_propagate_mean_and_its_gradients_match_jax(both_data, fmt, per_step):
    data = both_data[0]
    rows, cols, vals = data.get_norm_adj("sym")
    n_users, n_items = data.n_users, data.n_items
    rng = np.random.default_rng(4)
    u = rng.standard_normal((n_users, 12)).astype(np.float32)
    i = rng.standard_normal((n_items, 12)).astype(np.float32)
    gu = rng.standard_normal((n_users, 12)).astype(np.float32)
    gi = rng.standard_normal((n_items, 12)).astype(np.float32)
    step_vals = _dropped(vals) if per_step else None

    ref = jax_graph.pack_propagator(rows, cols, vals, n_users + n_items, fmt=fmt)
    jax_vals = None if step_vals is None else jnp.asarray(step_vals)

    def objective(u_, i_):
        fu, fi = jax_graph.propagate_mean(ref, u_, i_, 3, jax_vals)
        return jnp.sum(fu * gu) + jnp.sum(fi * gi), (fu, fi)

    (_, (want_u, want_i)), (want_du, want_di) = jax.value_and_grad(objective, argnums=(0, 1), has_aux=True)(
        jnp.asarray(u), jnp.asarray(i))

    prop = pack_propagator(rows, cols, vals, n_users + n_items, fmt=fmt, device="cpu")
    ut, it = torch.tensor(u, requires_grad=True), torch.tensor(i, requires_grad=True)
    fu, fi = propagate_mean(prop, ut, it, 3, None if step_vals is None else torch.as_tensor(step_vals))
    ((fu * torch.as_tensor(gu)).sum() + (fi * torch.as_tensor(gi)).sum()).backward()
    for got, want in ((fu, want_u), (fi, want_i), (ut.grad, want_du), (it.grad, want_di)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_pack_propagator_picks_routes_as_jax():
    rows, cols, vals, n = isolated_graph()
    assert pack_propagator(rows, cols, vals, n, device="cpu").format == "dense"  # n <= 4,096
    assert pack_propagator(rows, cols, vals, n, dense_max_nodes=n - 1, device="cpu").format == "csr"
    assert pack_propagator(rows, cols, vals, n, fmt="coo", device="cpu").format == "csr"
    assert jax_graph.pack_propagator(rows, cols, vals, n).format == "dense"
    with pytest.raises(ValueError, match="Unknown propagator format"):
        pack_propagator(rows, cols, vals, n, fmt="ell", device="cpu")


def test_edge_dropout_in_distribution():
    """Each edge kept with probability keep_prob (within 5 sigma over 200,000
    edges), the kept scaled by 1 / keep_prob, the rest 0; one seed draws
    one mask, and the next draw another."""
    keep = 0.6
    vals = torch.rand(200_000, generator=torch.Generator().manual_seed(0)) + 0.1
    gen = torch.Generator().manual_seed(1)
    first, second = edge_dropout(gen, vals, keep), edge_dropout(gen, vals, keep)
    kept = first != 0
    n = vals.numel()
    assert abs(int(kept.sum()) - keep * n) < 5 * np.sqrt(n * keep * (1 - keep))
    torch.testing.assert_close(first[kept], vals[kept] / keep, rtol=0, atol=0)
    assert torch.equal(edge_dropout(torch.Generator().manual_seed(1), vals, keep), first)
    assert not torch.equal(first, second)
    # The JAX package's rule is the same: its kept share over as many edges.
    jax_kept = np.asarray(jax_graph.edge_dropout(jax.random.key(0), jnp.asarray(vals.numpy()), keep)) != 0
    assert abs(int(jax_kept.sum()) - keep * n) < 5 * np.sqrt(n * keep * (1 - keep))
