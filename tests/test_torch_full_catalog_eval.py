"""The port's ``FullCatalogEvaluator`` and ``TopKRetrievalEvaluator`` against
the JAX package's on the same checkpoints and CSR inputs: the seed-0 MF
and LightGCN checkpoints on the structured split (the streaming route: its
largest train degree is 418), a small split that takes the fast route in
both modes, duplicate CSR entries, a last block that does not divide the
users, and an empty user list; and ``save_mode="per_user"``'s CSV against
the JAX package's file."""

import csv
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from beta_recsys_tpu import recommenders as jax_recommenders
from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.eval_engine import FullCatalogEvaluator as JaxFullCatalogEvaluator
from beta_recsys_tpu.core.eval_engine import TopKRetrievalEvaluator as JaxTopKRetrievalEvaluator
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.models.mf import MF as JaxMF
from beta_recsys_tpu_torch import recommenders
from beta_recsys_tpu_torch.config import load_config
from beta_recsys_tpu_torch.convert import params_to_jax
from beta_recsys_tpu_torch.core.checkpoint import load_metadata
from beta_recsys_tpu_torch.core.eval_engine import FullCatalogEvaluator, TopKRetrievalEvaluator
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.models.mf import MF
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_USER_COL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "port_tools"))
from jax_full_catalog_metrics import CHECKPOINTS, relevance  # noqa: E402

SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
# Means over ~900 users of float32 scores whose sums run in another order
# on each side; a flipped near-tie would move a mean by ~1e-3.
METRIC_TOL = 1e-6


def _assert_metrics(got, want):
    assert list(got) == list(want)
    for key in want:
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got[key], want[key])


@pytest.fixture(scope="module")
def split():
    return load_split_data(SPLIT, n_test=1), jax_load_split_data(SPLIT, n_test=1)


def _served(name, split):
    path = os.path.join(REPO, CHECKPOINTS[name])
    data = BaseData(split[0])
    ours = getattr(recommenders, {"MF": "MatrixFactorization"}.get(name, name))(load_config(path), device="cpu")
    ours.load(path, data)
    ref = getattr(jax_recommenders, {"MF": "MatrixFactorization"}.get(name, name))(
        JaxConfig(load_metadata(path)["config"]))
    ref.load(path, JaxBaseData(split[1]))
    test = data.test[0]
    users, rel = relevance(test[DEFAULT_USER_COL], test[DEFAULT_ITEM_COL], test[DEFAULT_RATING_COL],
                           data.n_users, data.n_items)
    return ours, ref, users, rel, data.user_item_csr()


@pytest.mark.parametrize("name", ["MF", "LightGCN"])
def test_both_evaluators_on_the_checkpoints_equal_jax(name, split):
    ours, ref, users, rel, train = _served(name, split)
    params = ref.engine.params
    _assert_metrics(FullCatalogEvaluator(ours.model, users, rel, train, user_block=400).evaluate(),
                    JaxFullCatalogEvaluator(ref.model, users, rel, train, user_block=400).evaluate(params))
    got = TopKRetrievalEvaluator(ours.model, users, rel, train, user_block=400)
    assert not got.use_fast  # 10 + 418 > 256
    _assert_metrics(got.evaluate(),
                    JaxTopKRetrievalEvaluator(ref.model, users, rel, train, user_block=400).evaluate(params))


def _small(seed=0, n_users=37, n_items=53, d=8):
    """A port MF and the JAX MF with the same random parameters, a train CSR
    with duplicate entries (one summing to zero), and relevance with a
    duplicated entry."""
    rng = np.random.default_rng(seed)
    port = MF({"emb_dim": d}, n_users, n_items, device="cpu").init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        port.user_bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(seed + 1))
        port.item_bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(seed + 2))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(port.state_dict()))
    rows = np.repeat(np.arange(n_users), 4)
    cols = rng.integers(0, n_items, len(rows))
    vals = np.ones(len(rows), np.float32)
    rows, cols, vals = np.r_[rows, 3, 3], np.r_[cols, 5, 5], np.r_[vals, 1.0, -1.0]
    train = sp.csr_matrix((vals, cols, np.r_[0, np.cumsum(np.bincount(rows, minlength=n_users))]),
                          shape=(n_users, n_items))
    order = np.argsort(rows, kind="stable")
    train = sp.csr_matrix((vals[order], cols[order], train.indptr), shape=(n_users, n_items))
    assert not train.has_canonical_format
    rel_rows = np.r_[np.arange(n_users), 0]
    rel_cols = np.r_[rng.integers(0, n_items, n_users), 9]
    rel = sp.csr_matrix((np.ones(len(rel_rows), np.float32), (rel_rows, rel_cols)), shape=(n_users, n_items))
    return port, JaxMF({"emb_dim": d}, n_users, n_items), params, train, rel


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("user_block", [8, 64])
def test_small_model_with_duplicates_equals_jax(mode, user_block):
    port, jax_model, params, train, rel = _small()
    users = np.arange(1, 37)
    _assert_metrics(FullCatalogEvaluator(port, users, rel, train, user_block=user_block).evaluate(),
                    JaxFullCatalogEvaluator(jax_model, users, rel, train, user_block=user_block).evaluate(params))
    got = TopKRetrievalEvaluator(port, users, rel, train, user_block=user_block, mode=mode)
    assert got.use_fast
    _assert_metrics(got.evaluate(), JaxTopKRetrievalEvaluator(jax_model, users, rel, train, user_block=user_block,
                                                              mode=mode).evaluate(params))


def test_small_model_streaming_route_equals_jax():
    """ks up to 253: 253 + the largest train degree (5) passes 256, so both
    sides stream, in item blocks that do not divide the catalog."""
    port, jax_model, params, train, rel = _small(1)
    users = np.arange(37)
    got = TopKRetrievalEvaluator(port, users, rel, train, ks=(5, 253), user_block=16, item_block=16)
    assert not got.use_fast
    _assert_metrics(got.evaluate(), JaxTopKRetrievalEvaluator(jax_model, users, rel, train, ks=(5, 253),
                                                              user_block=16, item_block=16).evaluate(params))


def test_empty_user_list_gives_jax_means():
    port, jax_model, params, train, rel = _small(2)
    users = np.zeros(0, np.int64)
    assert FullCatalogEvaluator(port, users, rel, train).evaluate() == \
        JaxFullCatalogEvaluator(jax_model, users, rel, train).evaluate(params) == {}
    got = TopKRetrievalEvaluator(port, users, rel, train).evaluate()
    want = JaxTopKRetrievalEvaluator(jax_model, users, rel, train).evaluate(params)
    assert got == want and set(got.values()) == {0.0}


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.array(rows[1:], dtype=np.float64)


def test_per_user_csv_equals_jax(split, tmp_path):
    path = os.path.join(REPO, CHECKPOINTS["MF"])
    roots = tmp_path / "port", tmp_path / "jax"
    cfg = load_config(path).replace(system={"root_dir": str(roots[0]), "save_mode": "per_user"})
    ours = recommenders.MatrixFactorization(cfg, device="cpu").load(path, BaseData(split[0]))
    raw = load_metadata(path)["config"]
    raw["system"].update(root_dir=str(roots[1]), save_mode="per_user")
    ref = jax_recommenders.MatrixFactorization(JaxConfig(raw)).load(path, JaxBaseData(split[1]))
    ours.test()
    ref.test()
    (got_file,) = glob.glob(str(roots[0] / "results" / "*_per_user.csv"))
    (want_file,) = glob.glob(str(roots[1] / "results" / "*_per_user.csv"))
    assert os.path.basename(got_file).startswith("MF_default_")
    got_head, got = _read(got_file)
    want_head, want = _read(want_file)
    assert got_head == want_head == ["col_user", "col_item", "col_rating", "col_prediction"]
    assert got.shape == want.shape == (943 * 101, 4)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    # sigmoids of float32 dot products summed in another order
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=1e-6)


def test_average_mode_writes_no_per_user_file(split, tmp_path):
    path = os.path.join(REPO, CHECKPOINTS["MF"])
    cfg = load_config(path).replace(system={"root_dir": str(tmp_path)})
    recommenders.MatrixFactorization(cfg, device="cpu").load(path, BaseData(split[0])).test()
    assert not glob.glob(str(tmp_path / "results" / "*_per_user.csv"))
    with pytest.raises(ValueError, match="save_mode"):
        recommenders.MatrixFactorization(cfg.replace(system={"save_mode": "per_item"}), device="cpu").load(
            path, BaseData(split[0])).test()
