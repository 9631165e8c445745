"""The rest of ``utils/common.py`` against the JAX package's: ``DictToObject``
on nested dicts, ``un_zip`` of a local archive (into its own directory and
into another), and ``normalized_adj_single`` bit for bit on matrices with
empty rows, in float32 and float64, from COO and CSR; ``BaseData`` builds its
row-normalized adjacencies with it."""

import os
import zipfile

import numpy as np
import pytest
import scipy.sparse as sp

from beta_recsys_tpu.utils import common as jax_common
from beta_recsys_tpu_torch.data import base_data
from beta_recsys_tpu_torch.utils import common
from tests.test_torch_train_mf import structured_split


def _attrs(obj):
    return {k: _attrs(v) if isinstance(v, (common.DictToObject, jax_common.DictToObject)) else v
            for k, v in vars(obj).items()}


def test_dict_to_object_matches_jax():
    config = {"system": {"seed": 1, "paths": {"root": "/data", "k": [5, 10]}}, "model": {"emb_dim": 64},
              "lr": 0.05, "tags": {}}
    ours, want = common.DictToObject(config), jax_common.DictToObject(config)
    assert _attrs(ours) == _attrs(want) == config
    assert ours.system.paths.root == "/data" and ours.model.emb_dim == 64 and ours.lr == 0.05
    assert isinstance(ours.tags, common.DictToObject) and vars(ours.tags) == {}


def _archive(path):
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("ml-100k/u.data", "1\t2\t5\t881250949\n")
        zf.writestr("ml-100k/u.item", "1|Toy Story (1995)|\n")
        zf.writestr("README", "raw files\n")


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("into_own_directory", [True, False])
def test_un_zip_matches_jax(tmp_path, into_own_directory):
    trees = []
    for side, fn in (("port", common.un_zip), ("jax", jax_common.un_zip)):
        raw = tmp_path / side / "raw"
        raw.mkdir(parents=True)
        archive = raw / "ml-100k.zip"
        _archive(archive)
        if into_own_directory:
            fn(str(archive))
            root = raw
        else:
            root = tmp_path / side / "out"
            fn(str(archive), str(root))
        trees.append(_tree(root))
    assert trees[0] == trees[1]
    assert trees[0]["ml-100k/u.data"] == b"1\t2\t5\t881250949\n"


def _matrices():
    rng = np.random.default_rng(0)
    dense = rng.uniform(0.1, 2.0, (12, 9)) * (rng.uniform(size=(12, 9)) < 0.3)
    dense[[0, 5, 11]] = 0.0  # rows of degree 0 stay 0
    for dtype in (np.float32, np.float64):
        yield sp.coo_matrix(dense.astype(dtype))
        yield sp.csr_matrix(dense.astype(dtype))
    users = rng.integers(0, 30, 200)
    items = rng.integers(0, 20, 200)
    graph = sp.coo_matrix((np.ones(200, np.float32), (users, 30 + items)), shape=(50, 50))
    yield (graph + graph.T).tocsr()  # duplicate entries summed, as BaseData's bipartite graph


@pytest.mark.parametrize("case", range(5))
def test_normalized_adj_single_matches_jax_bit_for_bit(case):
    adj = list(_matrices())[case]
    got, want = common.normalized_adj_single(adj), jax_common.normalized_adj_single(adj)
    assert got.format == want.format == "coo" and got.shape == want.shape and got.dtype == want.dtype
    for field in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_base_data_row_normalizes_with_it():
    """One copy remains: ``BaseData.create_adj_mat``'s D^-1 (A + I) and
    D^-1 A are ``normalized_adj_single`` of its A (tests/test_torch_graph.py
    holds the three to the JAX package's, bit for bit)."""
    assert base_data.normalized_adj_single is common.normalized_adj_single
    assert not hasattr(base_data, "_row_normalize")
    data = base_data.BaseData(structured_split())
    adj, norm_adj, mean_adj = data.create_adj_mat()
    for got, want in ((norm_adj, common.normalized_adj_single(adj + sp.eye(adj.shape[0], dtype=np.float32))),
                      (mean_adj, common.normalized_adj_single(adj))):
        want = want.tocsr()
        for field in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
