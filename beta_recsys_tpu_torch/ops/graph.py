"""Graph propagation (out = A @ x over the normalized user-item graph) and
edge dropout.

Counterpart of ``beta_recsys_tpu/ops/graph.py``. The JAX package packs the
COO artifact of ``BaseData.get_norm_adj`` into one of three scatter-free
TPU strategies; the port has two routes, both torch ops:

- **dense** (``DensePropagator``, the JAX ``DensePropagator``): A densified
  once at pack time, ``A @ x`` one matmul. Per-step edge values (dropout)
  are written into a zeroed (n, n) matrix once a step, shared by every layer;
  the (row, col) pairs are unique, so no sum's order enters.
- **sparse** (``CsrPropagator``): ``A @ x`` as a CSR product
  (``torch.sparse.mm``) whose backward is ``A^T @ g`` through a CSR of A^T
  built at pack time, with the permutations that carry COO-ordered edge
  values into either layout; autograd never transposes a sparse tensor. The
  JAX formats "chunked" (a windowed one-hot matmul: the TPU's MXU has no
  SpMM) and "coo" (gather + ``segment_sum``) both map to this route. On the
  card the CSR product is cuSPARSE's, which does not repeat bit for bit
  (``chip_smoke.py`` phase 20 reports it), so a seed repeats only on the
  dense route.

``pack_propagator``'s "auto" picks dense up to 4,096 nodes, as the JAX
package does. ``spmm_coo`` is the plain reference (gather, then
``index_add_``) the tests hold both routes to.

SGL's augmentation (``sgl_augment``, the JAX ``sgl_augment``) draws a
subgraph on the device and renormalizes it: node dropout keeps an edge when
both its ends are kept; edge dropout draws once per undirected pair
(``undirected_pairs``, built once on the host), so A stays symmetric.
"""

import warnings

import numpy as np
import torch

from ..device import resolve_device

_DENSE_MAX_NODES = 4096  # the JAX package's dense cap: 4096^2 float32 = 64 MB


def spmm_coo(rows, cols, vals, dense):
    """Sparse (n x n, COO) @ dense (n x d) -> (n x d)."""
    return torch.zeros_like(dense).index_add_(0, rows, dense[cols] * vals[:, None])


def edge_dropout(generator, vals, keep_prob):
    """Keep each edge with probability ``keep_prob``, drawn from
    ``generator`` on the values' device, scaling the kept by 1 / keep_prob."""
    keep = torch.rand(vals.shape, generator=generator, device=vals.device) < keep_prob
    return torch.where(keep, vals / keep_prob, 0.0)


def undirected_pairs(rows, cols):
    """(pair index of each directed edge, number of pairs): both directions
    of an edge share one index, the rank of its (min, max) end pair."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    n = int(max(rows.max(initial=-1), cols.max(initial=-1))) + 1
    pair_ids = np.minimum(rows, cols) * n + np.maximum(rows, cols)
    uniq, inverse = np.unique(pair_ids, return_inverse=True)
    return inverse.reshape(-1), len(uniq)


def sgl_draws(generator, n, device):
    """SGL's U[0, 1) draws, one a node (node dropout) or one an undirected
    pair (edge dropout), from ``generator`` on ``device``."""
    return torch.rand(n, generator=generator, device=device)


def sgl_augment(draws, rows, cols, edge_pair, n_nodes, aug_type=1, ssl_ratio=0.1):
    """The renormalized values of the subgraph that ``draws`` keep: aug_type
    0 (node dropout, a draw a node) keeps the edges whose two ends draw at
    least ``ssl_ratio``; 1 and 2 (edge dropout, random walk; a draw a pair of
    ``edge_pair``) the edges whose pair does. Values are 1 / sqrt(d_row
    d_col) over the kept degrees, 0 on dropped edges and isolated nodes."""
    if aug_type == 0:
        node_keep = draws >= ssl_ratio
        keep = node_keep[rows] & node_keep[cols]
    else:
        keep = (draws >= ssl_ratio)[edge_pair]
    ones = keep.to(torch.float32)
    # Integer counts: exact in any order of summation.
    deg = torch.zeros(n_nodes, device=ones.device).index_add_(0, rows, ones)
    d_inv_sqrt = torch.where(deg > 0, deg.clamp_min(1e-12).rsqrt(), 0.0)
    return ones * d_inv_sqrt[rows] * d_inv_sqrt[cols]


class DensePropagator:
    """out = A @ x with A densified once."""

    format = "dense"

    def __init__(self, rows, cols, vals, n_nodes, device):
        self.n_nodes = int(n_nodes)
        self.rows = torch.as_tensor(np.asarray(rows), dtype=torch.long, device=device)
        self.cols = torch.as_tensor(np.asarray(cols), dtype=torch.long, device=device)
        self.vals = torch.as_tensor(np.asarray(vals, np.float32), device=device)
        a = np.zeros((self.n_nodes, self.n_nodes), np.float32)
        np.add.at(a, (np.asarray(rows), np.asarray(cols)), np.asarray(vals, np.float32))
        self.dense = torch.as_tensor(a, device=device)

    def operator(self, vals=None):
        """x -> A @ x, A from ``vals`` (COO order; the packed values when
        None), built once for every call of the returned function."""
        a = self.dense
        if vals is not None:
            a = torch.zeros((self.n_nodes, self.n_nodes), dtype=vals.dtype, device=vals.device)
            a[self.rows, self.cols] = vals

        def apply(x):
            if x.dtype == a.dtype:
                return a @ x
            # Mixed precision, as the JAX dense route computes it: a float32
            # product of A (built in x's type from per-step values) and x,
            # returned in x's type.
            return ((a if vals is None else a.to(x.dtype)).float() @ x.float()).to(x.dtype)

        return apply

    def spmm(self, x, vals=None):
        return self.operator(vals)(x)


def _csr_layout(rows, cols, n_nodes):
    """(order, crow_indices, col_indices): the permutation of COO edges into
    CSR order (by row, then column), and the CSR index arrays."""
    order = np.lexsort((cols, rows))
    crow = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_nodes), out=crow[1:])
    return order, crow, cols[order]


class _CsrMatmul(torch.autograd.Function):
    """A @ x whose x-gradient is A^T @ g through a prebuilt CSR of A^T; the
    edge values take no gradient."""

    @staticmethod
    def forward(ctx, x, a, a_t):
        ctx.a_t = a_t
        return torch.sparse.mm(a, x)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.a_t, g.contiguous()), None, None


class CsrPropagator:
    """out = A @ x as CSR products, forward and backward."""

    format = "csr"

    def __init__(self, rows, cols, vals, n_nodes, device):
        self.n_nodes = int(n_nodes)
        rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
        self.vals = torch.as_tensor(np.asarray(vals, np.float32), device=device)
        self._layouts = []
        for r, c in ((rows, cols), (cols, rows)):  # A, then A^T
            order, crow, col = _csr_layout(r, c, self.n_nodes)
            self._layouts.append(tuple(torch.as_tensor(t, device=device) for t in (order, crow, col)))
        self._packed = self._matrices(self.vals)

    def _matrices(self, vals):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
            warnings.filterwarnings("ignore", "Sparse invariant checks are implicitly disabled")
            return tuple(
                torch.sparse_csr_tensor(crow, col, vals[order], size=(self.n_nodes, self.n_nodes),
                                        check_invariants=False)
                for order, crow, col in self._layouts
            )

    def operator(self, vals=None):
        """x -> A @ x, A from ``vals`` (COO order; the packed values when
        None), laid out once for every call of the returned function."""
        a, a_t = self._packed if vals is None else self._matrices(vals)
        rounded = {}

        def apply(x):
            if x.dtype == a.dtype:
                return _CsrMatmul.apply(x, a, a_t)
            # Mixed precision: the JAX sparse routes multiply x by the edge
            # values cast to x's type and return x's type. Torch has no
            # low-precision sparse product on the CPU, so the product runs
            # in float32 on the rounded values.
            if x.dtype not in rounded:
                rounded[x.dtype] = self._matrices((self.vals if vals is None else vals).to(x.dtype).float())
            return _CsrMatmul.apply(x.float(), *rounded[x.dtype]).to(x.dtype)

        return apply

    def spmm(self, x, vals=None):
        return self.operator(vals)(x)


def pack_propagator(rows, cols, vals, n_nodes, fmt="auto", dense_max_nodes=_DENSE_MAX_NODES, device=None):
    """The propagator of the COO graph (rows, cols, vals) on ``device`` (the
    GPU when None). fmt: "auto" (dense up to ``dense_max_nodes`` nodes, else
    sparse), "dense", or "chunked" / "coo" (the port's sparse route)."""
    device = resolve_device(device)
    if fmt == "auto":
        fmt = "dense" if n_nodes <= dense_max_nodes else "chunked"
    if fmt == "dense":
        return DensePropagator(rows, cols, vals, n_nodes, device)
    if fmt in ("chunked", "coo"):
        return CsrPropagator(rows, cols, vals, n_nodes, device)
    raise ValueError(f"Unknown propagator format {fmt!r}")


def propagate_mean(prop, user_emb, item_emb, n_layers, vals=None):
    """Layer-averaged LightGCN propagation: the mean of the joint (users +
    items) table and its ``n_layers`` propagations, split back into (users,
    items). ``vals`` (per-step edge values) serve every layer."""
    n_users = user_emb.shape[0]
    spmm = prop.operator(vals)
    emb = torch.cat([user_emb, item_emb])
    acc = emb
    for _ in range(n_layers):
        emb = spmm(emb)
        acc = acc + emb
    final = acc / (n_layers + 1)
    return final[:n_users], final[n_users:]
