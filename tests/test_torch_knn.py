"""UserKNN and ItemKNN in the port against the JAX package on the CPU: the
scores (UserKNN with ties at its k-th overlap, and with k past the user
count), the "none" batch kind (no epoch loop: one evaluation, the epoch-0
checkpoint with the JAX optimizer tree), and ``XRecommender(cfg,
device="cpu").train(data)`` whose checkpoint the JAX package loads and
tests to the port's metrics."""

import json

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
from test_torch_train_sasrec import sequence_split

from beta_recsys_tpu import recommenders as jax_recommenders
from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.models.knn import ItemKNN as JaxItemKNN
from beta_recsys_tpu.models.knn import UserKNN as JaxUserKNN
from beta_recsys_tpu_torch import recommenders
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.convert import knn_params_from_jax
from beta_recsys_tpu_torch.core.checkpoint import load_raw_checkpoint
from beta_recsys_tpu_torch.core.train_engine import TrainEngine
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.models import build_model
from beta_recsys_tpu_torch.models.knn import ItemKNN, UserKNN
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_USER_COL

N_USERS, N_ITEMS = 30, 40


def interactions(seed=0):
    """A 0/1 matrix whose users 20-29 repeat users 0-9's rows: every
    user's overlaps tie in pairs, at the k-th largest too."""
    rng = np.random.default_rng(seed)
    R = (rng.random((N_USERS, N_ITEMS)) < 0.25).astype(np.float32)
    R[20:] = R[:10]
    R[5, :] = 0  # a user without items
    return sp.csr_matrix(R * rng.integers(1, 4, R.shape))  # counts > 1 binarize to 1


@pytest.mark.parametrize("k", [1, 4, 7, 30, 45])
def test_user_knn_scores_match_jax_with_ties(k):
    csr = interactions()
    ours = UserKNN({"neighbourhood_size": k}, N_USERS, N_ITEMS, {"interactions": csr}, device="cpu")
    ref = JaxUserKNN({"neighbourhood_size": k}, N_USERS, N_ITEMS, {"interactions": csr})
    users = np.arange(N_USERS)
    got = ours.score_all(torch.as_tensor(users)).numpy()
    want = np.asarray(ref.score_all(None, jnp.asarray(users)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # The threshold keeps ties: some user has more than k neighbours at or above it.
    R = csr.toarray() > 0
    overlap = (R.astype(np.float32) @ R.T.astype(np.float32)) / np.sqrt(np.maximum(R.sum(1), 1))[None, :]
    kth = np.sort(overlap, axis=1)[:, -min(k, N_USERS)][:, None]
    if k < N_USERS:
        assert ((overlap >= kth).sum(1) > k).any()
    assert (got[R] == -1e30).all() and (got[~R] > -1e30).all()
    cand = np.random.default_rng(1).integers(0, N_ITEMS, (N_USERS, 9))
    np.testing.assert_allclose(ours.score_candidates(torch.as_tensor(users), torch.as_tensor(cand)).numpy(),
                               np.asarray(ref.score_candidates(None, jnp.asarray(users), jnp.asarray(cand))),
                               rtol=1e-6, atol=1e-6)


def test_item_knn_scores_match_jax():
    csr = interactions(2)
    ours = ItemKNN({"neighbourhood_size": 3}, N_USERS, N_ITEMS, {"interactions": csr}, device="cpu")
    ref = JaxItemKNN({"neighbourhood_size": 3}, N_USERS, N_ITEMS, {"interactions": csr.toarray()})
    np.testing.assert_allclose(ours.sim.numpy(), np.asarray(ref.sim), rtol=1e-6, atol=1e-7)
    users = np.array([0, 5, 29, 3, 3])
    np.testing.assert_allclose(ours.score_all(torch.as_tensor(users)).numpy(),
                               np.asarray(ref.score_all(None, jnp.asarray(users))), rtol=1e-6, atol=1e-6)


def test_params_are_one_zero_and_pairs_raise():
    model = UserKNN({}, N_USERS, N_ITEMS, {"interactions": interactions()}, device="cpu")
    assert model.k == 50 and model.batch_kind == "none"
    state = model.init_weights(torch.Generator().manual_seed(0)).state_dict()
    assert list(state) == ["_"] and state["_"].shape == () and float(state["_"]) == 0.0
    assert float(model.loss({})) == 0.0
    model.load_state_dict(knn_params_from_jax({"_": np.zeros((), np.float32)}))
    with pytest.raises(NotImplementedError):  # no pair score, as the JAX package's
        model.score_pairs(torch.tensor([0]), torch.tensor([1]))


@pytest.fixture(scope="module")
def both():
    split = sequence_split()
    train, valid, test = split
    frames = (pd.DataFrame(train), [pd.DataFrame(f) for f in valid], [pd.DataFrame(f) for f in test])
    return BaseData(split), JaxBaseData(frames)


def _config(root, name):
    return {
        "system": {"root_dir": str(root), "metrics": ["ndcg", "recall", "precision", "map"], "k": [5, 10],
                   "valid_metric": "ndcg", "valid_k": 10, "seed": 3, "result_file": f"{name}_test.csv"},
        "dataset": {"dataset": "synthetic", "data_split": "leave_one_out"},
        "model": {"model": name, "neighbourhood_size": 6, "optimizer": "adam", "lr": 0.001, "max_epoch": 1,
                  "max_n_update": 1},
    }


@pytest.mark.parametrize("name", ["UserKNN", "ItemKNN"])
def test_training_evaluates_once_and_the_jax_package_loads_the_checkpoint(both, tmp_path, name):
    """``train`` runs no epoch: one validation, the epoch-0 checkpoint with
    Adam's untouched state over ``_`` (the JAX engine's tree), no ``last/``;
    the JAX package's training gives the same validation and test()
    metrics, and its load() of the port's checkpoint the same test() and
    top-5 lists."""
    data, jax_data = both
    rec = getattr(recommenders, name)(Config(_config(tmp_path / "port", name)), device="cpu")
    result = rec.train(data)
    assert rec.engine.epoch_fn is None and result["best_epoch"] == 0
    assert rec.engine.bookkeeper.history[0]["epoch"] == 0
    raw = load_raw_checkpoint(result["model_save_dir"])
    assert set(raw["params"]) == {"_"} and float(raw["params"]["_"]) == 0.0
    assert int(raw["opt_state"]["0"]["count"]) == 0 and raw["opt_state"]["1"] == {}
    assert float(raw["opt_state"]["0"]["mu"]["_"]) == float(raw["opt_state"]["0"]["nu"]["_"]) == 0.0
    assert not (tmp_path / "port" / "checkpoints" / rec.engine.model_run_id / "last").exists()
    ours = rec.test()

    cfg = json.loads(json.dumps(_config(tmp_path / "jax", name)))
    trained = getattr(jax_recommenders, name)(JaxConfig(cfg))
    jax_result = trained.train(jax_data)
    assert jax_result["best_epoch"] == 0
    np.testing.assert_allclose(result["valid_metric"], jax_result["valid_metric"], rtol=1e-6, atol=1e-7)
    want = trained.test()
    assert list(ours) == sorted(want)
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)
    loaded = getattr(jax_recommenders, name)(JaxConfig(cfg)).load(result["model_save_dir"], jax_data)
    again = loaded.test()
    for key in want:
        np.testing.assert_allclose(ours[key], again[key], rtol=1e-6, atol=1e-7, err_msg=key)
    users = np.arange(12)
    got_rec, want_rec = rec.recommend(users=users, k=5), loaded.recommend(users=users, k=5)
    np.testing.assert_array_equal(got_rec[DEFAULT_ITEM_COL], want_rec[DEFAULT_ITEM_COL].to_numpy())
    np.testing.assert_array_equal(got_rec[DEFAULT_USER_COL], want_rec[DEFAULT_USER_COL].to_numpy())


def test_a_mesh_of_several_devices_raises(both, tmp_path):
    """The "none" kind on a (2, 1) mesh: nothing to train, the validation
    evaluated on the mesh's data shards, equal to one device's."""
    data, _ = both
    cfg = Config(_config(tmp_path, "UserKNN")).replace(system={"mesh": {"data": 2, "model": 1}})
    model = build_model(cfg.model, data.n_users, data.n_items, {"interactions": data.user_item_csr()}, device="cpu")
    valid = data.eval_candidates(data.valid[0])
    engine = TrainEngine(cfg, "cpu", mesh_devices=["cpu"] * 2).build(model, data, valid)
    assert engine.epoch_fn is None and engine.valid_evaluator.mesh is engine.mesh
    result = engine.train(verbose=False)
    want = TrainEngine(Config(_config(tmp_path, "UserKNN")), "cpu").build(model, data, valid).valid_evaluator.evaluate()
    key = engine.bookkeeper.key
    np.testing.assert_allclose(result["valid_metric"], want[key], rtol=1e-6)
