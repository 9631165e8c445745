"""``beta_recsys_tpu/ops/gather.py`` has no counterpart module in the port by
design: ``table_lookup`` and ``grouped_table_lookup`` are backward
strategies for the v5e's scatter (a one-hot matmul, a sort and segment sum)
behind the same values as ``table[ids]``. Here, on MF-, NCF- and
LightGCN-sized tables, the values and gradients of JAX ``table_lookup`` (its
one-hot regime, and ``_compact_lookup_for`` called directly) and
``grouped_table_lookup`` equal the port's indexing and its autograd gradient
within float tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beta_recsys_tpu.ops.gather import (
    MXU_LOOKUP_MAX_ROWS,
    _compact_lookup_for,
    grouped_table_lookup,
    table_lookup,
)

# float32 sums of a row's cotangents in other orders (a matmul against a
# one-hot, a sorted segment sum, torch's index accumulation).
RTOL, ATOL = 1e-5, 1e-5

# (table rows, width, ids shape): MF's user and item tables at
# configs/mf_default.json (emb 64, batch 400: B users, 2B items), NCF's GMF
# and MLP tables (emb 8, batch 400 x (1 + 4 negatives)), LightGCN's node
# table over users + items (emb 64, batch 1,024) and a (B, T) sequence of ids.
SHAPES = {
    "mf-users": (943, 64, (400,)),
    "mf-items": (1682, 64, (800,)),
    "ncf-items": (1682, 8, (2000,)),
    "lightgcn-nodes": (2625, 64, (3072,)),
    "ids-2d": (1682, 16, (32, 50)),
}


def _case(name, seed=0):
    n_rows, width, ids_shape = SHAPES[name]
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n_rows, width)).astype(np.float32)
    ids = (rng.zipf(1.3, ids_shape) - 1) % n_rows  # duplicates, as real ids have
    cot = rng.standard_normal((*ids_shape, width)).astype(np.float32)
    return table, ids.astype(np.int32), cot


def _port(table, ids, cot):
    """The port's lookup: indexing, and its autograd gradient."""
    t = torch.from_numpy(table).requires_grad_()
    out = t[torch.from_numpy(ids).long()]
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


def _jax(lookup, table, ids, cot):
    out, vjp = jax.vjp(lambda t: lookup(t, jnp.asarray(ids)), jnp.asarray(table))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("route", ["one-hot", "compact"])
def test_table_lookup_equals_indexing(name, route):
    table, ids, cot = _case(name)
    assert table.shape[0] <= MXU_LOOKUP_MAX_ROWS  # table_lookup takes its one-hot backward
    lookup = table_lookup if route == "one-hot" else _compact_lookup_for(table.shape, "float32")
    got_out, got_grad = _port(table, ids, cot)
    want_out, want_grad = _jax(lookup, table, ids, cot)
    np.testing.assert_array_equal(got_out, want_out)  # the forward is a gather on both sides
    np.testing.assert_allclose(got_grad, want_grad, rtol=RTOL, atol=ATOL)


def test_one_d_tables_equal_indexing():
    """A bias vector (MF's item_bias) through both JAX backwards."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal(1682).astype(np.float32)
    ids = rng.integers(0, 1682, 800).astype(np.int32)
    cot = rng.standard_normal(800).astype(np.float32)
    got_out, got_grad = _port(table, ids, cot)
    for lookup in (table_lookup, _compact_lookup_for(table.shape, "float32")):
        want_out, want_grad = _jax(lookup, table, ids, cot)
        np.testing.assert_array_equal(got_out, want_out)
        np.testing.assert_allclose(got_grad, want_grad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("widths", [(64, 1), (8, 32)], ids=["mf-emb-bias", "ncf-gmf-mlp"])
def test_grouped_table_lookup_equals_indexing_each_table(widths):
    """Tables of one height looked up with the same ids (MF's item_emb and
    item_bias; NCF's GMF and MLP item tables) share one JAX backward; the
    port indexes each."""
    rng = np.random.default_rng(2)
    n_rows, ids = 1682, rng.integers(0, 1682, 800).astype(np.int32)
    tables = [rng.standard_normal((n_rows, w) if w > 1 else n_rows).astype(np.float32) for w in widths]
    cots = [rng.standard_normal((800, w) if w > 1 else 800).astype(np.float32) for w in widths]
    outs, vjp = jax.vjp(lambda ts: grouped_table_lookup(ts, jnp.asarray(ids)), tuple(jnp.asarray(t) for t in tables))
    want_grads = vjp(tuple(jnp.asarray(c) for c in cots))[0]
    for table, cot, want_out, want_grad in zip(tables, cots, outs, want_grads):
        got_out, got_grad = _port(table, ids, cot)
        np.testing.assert_array_equal(got_out, np.asarray(want_out))
        np.testing.assert_allclose(got_grad, np.asarray(want_grad), rtol=RTOL, atol=ATOL)
