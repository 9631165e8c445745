"""The port serves the JAX package's trained seed-0 LightGCN and NGCF
checkpoints (load -> test -> predict -> recommend) with the JAX package's
numbers, on the CPU, through the dense route and the sparse route; a
``recommend()`` in several user blocks propagates once; and NGCF's nested
``gc``/``bi`` lists go through the msgpack reader and writer both ways."""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.recommenders import NGCF as JaxNGCF
from beta_recsys_tpu.recommenders import LightGCN as JaxLightGCN
from beta_recsys_tpu_torch.config import load_config
from beta_recsys_tpu_torch.convert import flatten_params, params_to_jax
from beta_recsys_tpu_torch.core.checkpoint import load_metadata, load_raw_checkpoint, msgpack_restore, msgpack_serialize
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.recommenders import NGCF, LightGCN
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_PREDICTION_COL, DEFAULT_USER_COL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
CHECKPOINTS = {
    "LightGCN": ("lightgcn_default_20260821_134437_yybcvt", LightGCN, JaxLightGCN),
    "NGCF": ("ngcf_default_20260821_135007_yybcvt", NGCF, JaxNGCF),
}
# The JAX package's XRecommender(...).load(checkpoint, data).test() on this split.
EXPECTED = {
    "LightGCN": {"ndcg@10": 0.286911, "recall@10": 0.603393, "precision@10": 0.060339, "map@10": 0.192452},
    "NGCF": {"ndcg@10": 0.256701, "recall@10": 0.568399, "precision@10": 0.056840, "map@10": 0.164256},
}
# Served scores: three propagations of 2,625 nodes, summed in other orders by
# XLA and torch (as the other serving tests allow).
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6


def _path(name):
    return os.path.join(REPO, "parity_runs/checkpoints", CHECKPOINTS[name][0])


@pytest.fixture(scope="module")
def data():
    return BaseData(load_split_data(SPLIT, n_test=1))


@pytest.fixture(scope="module", params=list(CHECKPOINTS))
def served(request, data, tmp_path_factory):
    """(name, port recommender, JAX recommender, port test() row, JAX test() row)."""
    name = request.param
    path, ours_cls, ref_cls = _path(name), *CHECKPOINTS[name][1:]
    cfg = load_config(path).replace(system={"root_dir": str(tmp_path_factory.mktemp("port"))})
    ours = ours_cls(cfg, device="cpu").load(path, data)
    raw = load_metadata(path)["config"]
    raw["system"]["root_dir"] = str(tmp_path_factory.mktemp("jax"))
    ref = ref_cls(JaxConfig(raw)).load(path, JaxBaseData(jax_load_split_data(SPLIT, n_test=1)))
    return name, ours, ref, ours.test(), ref.test()


def test_port_reproduces_checkpoint_metrics(served):
    name, ours, _, got, _ = served
    assert ours.model.prop.format == "dense"  # "auto" at 2,625 nodes, as the JAX package picks
    for key, want in EXPECTED[name].items():
        assert abs(got[key] - want) < 1e-5, key


def test_every_metric_equals_jax_test(served):
    _, _, _, ours, ref = served
    assert list(ours) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-6, atol=1e-7, err_msg=key)


def test_sparse_route_serves_the_same_metrics(served, data, tmp_path):
    name, _, _, dense, _ = served
    cfg = load_config(_path(name)).replace(system={"root_dir": str(tmp_path)}, model={"graph_format": "chunked"})
    rec = CHECKPOINTS[name][1](cfg, device="cpu").load(_path(name), data)
    assert rec.model.prop.format == "csr"
    got = rec.test()
    for key in dense:
        assert abs(got[key] - dense[key]) <= 1e-5, key


def test_recommend_matches_jax(served):
    _, ours, ref, _, _ = served
    users = np.arange(50)
    got = ours.recommend(users=users, k=10)
    want = ref.recommend(users=users, k=10)
    for col in (DEFAULT_USER_COL, DEFAULT_ITEM_COL, "rank"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy(), err_msg=col)
    np.testing.assert_allclose(got[DEFAULT_PREDICTION_COL], want[DEFAULT_PREDICTION_COL].to_numpy(),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    train = ours.data.user_item_csr()
    assert not np.asarray(train[got[DEFAULT_USER_COL], got[DEFAULT_ITEM_COL]]).any()


def test_recommend_propagates_once_over_its_user_blocks(served, monkeypatch):
    _, ours, _, _, _ = served
    calls = []
    real = type(ours.model).propagate
    monkeypatch.setattr(type(ours.model), "propagate", lambda self, *a: calls.append(a) or real(self, *a))
    whole = ours.recommend(k=10)
    assert len(calls) == 1
    blocked = ours.recommend(k=10, user_block=100)
    assert len(calls) == 2
    for col in whole:
        np.testing.assert_array_equal(blocked[col], whole[col], err_msg=col)


def test_predict_matches_jax(served):
    name, ours, ref, _, _ = served
    frame = {c: ours.data.test[0][c][:300] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    got = ours.predict(frame)
    assert got.shape == (300,) and np.isfinite(got).all()
    if name == "LightGCN":  # a sigmoid; NGCF's scores are raw dot products
        assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, np.asarray(ref.predict(ref.data.test[0].iloc[:300])), rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_msgpack_reader_and_writer_carry_the_graph_trees(name, data):
    """The reader decodes the checkpoint as flax does (NGCF's ``gc`` and
    ``bi`` arrive as maps keyed "0", "1", ...); the tree the port writes
    back, flax reads and ``from_state_dict`` restores onto the JAX
    ``init_params`` tree, whose ``gc`` and ``bi`` are lists, bit for bit."""
    with open(os.path.join(_path(name), "checkpoint.msgpack"), "rb") as f:
        blob = f.read()
    ours = msgpack_restore(blob)
    want = serialization.msgpack_restore(blob)
    for key, value in jax.tree_util.tree_leaves_with_path(want):
        got = ours
        for part in key:
            got = got[part.key]
        np.testing.assert_array_equal(got, value)
    if name == "NGCF":
        assert set(ours["params"]["gc"]) == set(ours["params"]["bi"]) == {"0", "1", "2"}

    rec = CHECKPOINTS[name][1](load_config(_path(name)), device="cpu").load(_path(name), data)
    back = serialization.msgpack_restore(msgpack_serialize({"params": params_to_jax(rec.model.state_dict())}))
    ref = CHECKPOINTS[name][2](JaxConfig(load_metadata(_path(name))["config"]))
    ref.load(_path(name), JaxBaseData(jax_load_split_data(SPLIT, n_test=1)))
    restored = serialization.from_state_dict(ref.engine.params, back["params"])
    got = flatten_params(jax.tree_util.tree_map(np.asarray, restored))
    want = flatten_params(load_raw_checkpoint(_path(name))["params"])
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
