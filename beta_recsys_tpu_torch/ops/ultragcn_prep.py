"""UltraGCN's item-item constraint on the host: each item's top-K neighbours
by weighted co-occurrence.

The port's own numpy copy of ``beta_recsys_tpu/ops/ultragcn_prep.py``: the
item x item co-occurrence G = R^T R of the binarized train matrix, weighted
sqrt(g_i + 1) / g_i * G_ij / sqrt(g_j + 1) (g the row and column sums of
G), blocked over rows, with the same ``argpartition`` and stable ``argsort``,
so tied weights give the same neighbour order.
"""

import numpy as np


def get_ii_constraint_mat(train_mat, num_neighbors, ii_diagonal_zero=False, block=2048):
    """(neighbours (n_items, K) int64, weights (n_items, K) float32), each row
    in descending weight, K = min(num_neighbors, n_items), from a scipy CSR
    (n_users, n_items) of binarized interactions."""
    co = (train_mat.T @ train_mat).tocsr()
    n_items = co.shape[0]
    if ii_diagonal_zero:
        co.setdiag(0)
        co.eliminate_zeros()
    items_d = np.asarray(co.sum(axis=0)).flatten()
    users_d = np.asarray(co.sum(axis=1)).flatten()
    with np.errstate(divide="ignore", invalid="ignore"):
        beta_ud = np.sqrt(users_d + 1) / users_d
    beta_ud[~np.isfinite(beta_ud)] = 0.0
    beta_id = 1.0 / np.sqrt(items_d + 1)

    k = min(num_neighbors, n_items)
    res_idx = np.zeros((n_items, k), dtype=np.int64)
    res_sim = np.zeros((n_items, k), dtype=np.float32)
    for start in range(0, n_items, block):
        end = min(start + block, n_items)
        dense = np.asarray(co[start:end].todense(), dtype=np.float32)
        weighted = beta_ud[start:end, None] * dense * beta_id[None, :]
        part = np.argpartition(-weighted, k - 1, axis=1)[:, :k]
        part_vals = np.take_along_axis(weighted, part, axis=1)
        order = np.argsort(-part_vals, axis=1, kind="stable")
        res_idx[start:end] = np.take_along_axis(part, order, axis=1)
        res_sim[start:end] = np.take_along_axis(part_vals, order, axis=1)
    return res_idx, res_sim
