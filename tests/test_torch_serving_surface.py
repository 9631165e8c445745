"""The port's serving surface against the JAX package's ``Recommender``:
``recommend()`` through its three routes (fast, streaming, ``score_all``),
each with its JAX counterpart's exclusion rule for a zero-rated train row,
``predict()``, ``export_embeddings()``, ``use_best`` both ways with serving
that stays call-order independent, ``load`` on a trained recommender
restoring the engine's state, and the config keys that raise.

Ids must be equal; scores agree to float32 rounding (dot products summed
in another order, then the model's score transform)."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from beta_recsys_tpu import recommenders as jax_recommenders
from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.data.sequential_data import SequentialData as JaxSequentialData
from beta_recsys_tpu_torch import recommenders
from beta_recsys_tpu_torch.config import Config, load_config
from beta_recsys_tpu_torch.convert import params_to_jax
from beta_recsys_tpu_torch.core.checkpoint import load_metadata, save_checkpoint, save_metadata
from beta_recsys_tpu_torch.core.train_engine import TrainEngine
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.data.sequential_data import SequentialData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_PREDICTION_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)
from test_torch_train_mf import structured_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
LIGHTGCN = os.path.join(REPO, "parity_runs/checkpoints/lightgcn_default_20260821_134437_yybcvt")
SASREC = os.path.join(REPO, "parity_runs/checkpoints/SASRec_default_20260821_081415_yybcvt")
SCORE_TOL = 1e-6


def _frames_to_jax(split):
    train, valid, test = split
    return pd.DataFrame(train), [pd.DataFrame(f) for f in valid], [pd.DataFrame(f) for f in test]


def with_zero_rated_rows(split, n=12, seed=0):
    """The split with ``n`` extra train rows of rating 0 (``binarize`` keeps
    them at 0): each a (user, item) the user has no train row for, newest in
    the user's history."""
    train, valid, test = split
    rng = np.random.default_rng(seed)
    users = rng.choice(np.unique(train[DEFAULT_USER_COL]), n, replace=False)
    items = np.unique(train[DEFAULT_ITEM_COL])
    extra_i = [rng.choice(np.setdiff1d(items, train[DEFAULT_ITEM_COL][train[DEFAULT_USER_COL] == u])) for u in users]
    stamp = train[DEFAULT_TIMESTAMP_COL].max() + 1
    extra = {DEFAULT_USER_COL: users, DEFAULT_ITEM_COL: np.array(extra_i), DEFAULT_RATING_COL: np.zeros(n),
             DEFAULT_TIMESTAMP_COL: np.full(n, stamp)}
    train = {c: np.concatenate([train[c], extra[c].astype(train[c].dtype)]) for c in train}
    return (train, valid, test), (users, np.array(extra_i))


def _same(got, want, tol=SCORE_TOL):
    for col in (DEFAULT_USER_COL, DEFAULT_ITEM_COL, "rank"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy(), err_msg=col)
    np.testing.assert_allclose(got[DEFAULT_PREDICTION_COL], want[DEFAULT_PREDICTION_COL].to_numpy(), rtol=1e-6,
                               atol=tol)


def _mf_checkpoint(root, data, seed=0, emb_dim=8, boost=()):
    """A directory holding an MF with random weights (random biases too;
    the item biases of ``boost`` raised by 3, so those items rank high), in
    the layout both packages load."""
    cfg = Config({"model": {"model": "MF", "emb_dim": emb_dim}, "system": {"root_dir": str(root)},
                  "dataset": {}})
    rec = recommenders.MatrixFactorization(cfg, device="cpu").init(data, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        rec.model.user_bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(seed + 1))
        rec.model.item_bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(seed + 2))
        rec.model.global_bias.fill_(0.25)
        rec.model.item_bias[torch.as_tensor(np.asarray(boost, np.int64))] += 3.0
    path = os.path.join(str(root), "mf_random")
    params = params_to_jax(rec.model.state_dict())
    zeros = {name: np.zeros_like(value) for name, value in params.items()}
    save_checkpoint(path, {"params": params,  # the JAX engine's serving reads the whole state
                           "opt_state": {"0": {"count": np.int32(0), "mu": zeros, "nu": zeros}, "1": {}},
                           "rng": np.array([0, seed], np.uint32)})
    save_metadata(path, {"n_users": data.n_users, "n_items": data.n_items, "config": cfg.to_dict()})
    return cfg, path


def _pair(cfg, path, split, cls="MatrixFactorization", port_data=BaseData, jax_data=JaxBaseData):
    ours = getattr(recommenders, cls)(cfg, device="cpu").load(path, port_data(split))
    ref = getattr(jax_recommenders, cls)(JaxConfig(cfg.to_dict())).load(path, jax_data(_frames_to_jax(split)))
    return ours, ref


@pytest.fixture(scope="module")
def fast_split():
    return with_zero_rated_rows(structured_split(), n=6)


@pytest.fixture(scope="module")
def streaming_split():
    return with_zero_rated_rows(load_split_data(SPLIT, n_test=1), n=6)


def _zero_rated_dense(data, zero):
    """The dense (user, item) ids of the zero-rated rows."""
    return (np.array([np.flatnonzero(data.user_pool == x)[0] for x in zero[0]]),
            np.array([np.flatnonzero(data.item_pool == x)[0] for x in zero[1]]))


@pytest.mark.parametrize("route", ["fast", "streaming"])
def test_mf_recommend_excludes_as_the_jax_route(route, fast_split, streaming_split, tmp_path):
    """The fast route excludes the zero-rated train items (every stored
    entry), the streaming route keeps them (positive summed rating only), as
    the JAX package's routes do."""
    split, zero = fast_split if route == "fast" else streaming_split
    data = BaseData(split)
    assert (data.user_item_csr().data == 0).sum() == len(zero[0])
    users, items = _zero_rated_dense(data, zero)
    cfg, path = _mf_checkpoint(tmp_path, data, boost=items)
    ours, ref = _pair(cfg, path, split)
    k = 10
    got, want = ours.recommend(k=k), ref.recommend(k=k)
    _same(got, want)
    # Unexcluded, every zero-rated item is in its user's top k.
    free = ours.recommend(users=users, k=k, exclude_train=False)
    assert all(items[n] in free[DEFAULT_ITEM_COL][n * k:(n + 1) * k] for n in range(len(users)))
    got_lists = got[DEFAULT_ITEM_COL].reshape(-1, k)[users]
    in_got = np.array([items[n] in got_lists[n] for n in range(len(users))])
    assert not in_got.any() if route == "fast" else in_got.all()
    _same(free, ref.recommend(users=users, k=k, exclude_train=False))


def test_mf_recommend_modes_and_score_dtypes_equal_jax(fast_split, tmp_path):
    split, _ = fast_split
    cfg, path = _mf_checkpoint(tmp_path, BaseData(split), seed=3)
    ours, ref = _pair(cfg, path, split)
    _same(ours.recommend(k=5, mode="exact", score_dtype="float32"),
          ref.recommend(k=5, mode="exact", score_dtype="float32"))
    # bfloat16 scores: the same ids; the score transform of bf16-rounded sums
    _same(ours.recommend(k=5, mode="exact", score_dtype="bfloat16", user_block=16),
          ref.recommend(k=5, mode="exact", score_dtype="bfloat16", user_block=16), tol=1e-6)
    approx = ours.recommend(k=5, mode="approx", score_dtype="bfloat16")
    exact = ours.recommend(k=5, mode="exact", score_dtype="bfloat16")
    np.testing.assert_array_equal(approx[DEFAULT_ITEM_COL], exact[DEFAULT_ITEM_COL])


def test_mf_predict_and_export_equal_jax(fast_split, tmp_path):
    split, _ = fast_split
    cfg, path = _mf_checkpoint(tmp_path, BaseData(split), seed=4)
    ours, ref = _pair(cfg, path, split)
    frame = {c: ours.data.test[0][c] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    np.testing.assert_allclose(ours.predict(frame), np.asarray(ref.predict(ref.data.test[0])), rtol=0,
                               atol=SCORE_TOL)
    got = np.load(ours.export_embeddings(str(tmp_path / "ours.npz")))
    want = np.load(ref.export_embeddings(str(tmp_path / "jax.npz")))
    assert sorted(got.files) == sorted(want.files) == ["item_emb", "user_emb"]
    for key in ("user_emb", "item_emb"):
        np.testing.assert_array_equal(got[key], want[key])
    u, i = ours.model.user_item_embeddings_trimmed()
    assert np.array_equal(got["user_emb"], u.detach().numpy()) and np.array_equal(got["item_emb"], i.detach().numpy())


@pytest.fixture(scope="module")
def lightgcn():
    return _pair(load_config(LIGHTGCN), LIGHTGCN, load_split_data(SPLIT, n_test=1), cls="LightGCN")


@pytest.mark.parametrize("exclude_train", [True, False])
def test_lightgcn_recommend_both_routes_equal_jax(lightgcn, exclude_train):
    ours, ref = lightgcn
    users = np.arange(0, 943, 7)
    _same(ours.recommend(users=users, k=10, exclude_train=exclude_train, item_block=500),
          ref.recommend(users=users, k=10, exclude_train=exclude_train, item_block=500))


def test_lightgcn_exports_the_propagated_tables(lightgcn, tmp_path):
    ours, ref = lightgcn
    got = np.load(ours.export_embeddings(str(tmp_path / "ours.npz")))
    want = np.load(ref.export_embeddings(str(tmp_path / "jax.npz")))
    for key in ("user_emb", "item_emb"):
        # three propagation layers of float32 sparse products
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)
    scores = got["user_emb"][:5] @ got["item_emb"][:7].T
    frame = {DEFAULT_USER_COL: np.repeat(np.arange(5), 7), DEFAULT_ITEM_COL: np.tile(np.arange(7), 5)}
    logits = ours.predict(frame)
    np.testing.assert_allclose(1 / (1 + np.exp(-scores.reshape(-1))), logits, rtol=0, atol=1e-6)


def test_sasrec_score_all_route_keeps_zero_rated_items_as_jax(streaming_split, tmp_path):
    split, zero = streaming_split
    cfg = load_config(SASREC).replace(system={"root_dir": str(tmp_path)})
    ours, ref = _pair(cfg, SASREC, split, cls="SASRec", port_data=SequentialData, jax_data=JaxSequentialData)
    users, _ = _zero_rated_dense(ours.data, zero)
    _same(ours.recommend(users=users, k=10), ref.recommend(users=users, k=10), tol=1e-5)
    with pytest.raises(ValueError, match="factorized"):
        ours.export_embeddings(str(tmp_path / "x.npz"))


def _trained_mf(root, split, epochs=8):
    cfg = Config({"model": {"model": "MF", "emb_dim": 8, "lr": 0.2, "max_epoch": epochs, "batch_size": 64,
                            "optimizer": "adam"},
                  "system": {"root_dir": str(root), "seed": 1, "metrics": ["ndcg"], "k": [5], "valid_k": 5},
                  "dataset": {}})
    rec = recommenders.MatrixFactorization(cfg, device="cpu")
    rec.train(BaseData(split))
    return cfg, rec


def test_use_best_both_ways_equal_jax_and_stay_call_order_independent(fast_split, tmp_path):
    split, _ = fast_split
    cfg, ours = _trained_mf(tmp_path / "port", split)
    assert ours.engine.bookkeeper.best_epoch < 7  # the best and the final parameters differ
    best_dir = ours.engine.checkpoint_dir
    last_dir = os.path.join(best_dir, "last")
    jax_best = jax_recommenders.MatrixFactorization(JaxConfig(cfg.to_dict())).load(
        best_dir, JaxBaseData(_frames_to_jax(split)))
    jax_last = jax_recommenders.MatrixFactorization(JaxConfig(cfg.to_dict())).load(
        last_dir, JaxBaseData(_frames_to_jax(split)))
    frame = {c: ours.data.test[0][c] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    first = ours.recommend(k=5)
    final = ours.recommend(k=5, use_best=False)
    _same(first, jax_best.recommend(k=5))
    _same(final, jax_last.recommend(k=5))
    assert not np.array_equal(first[DEFAULT_ITEM_COL], final[DEFAULT_ITEM_COL])
    final_scores = ours.predict(frame, use_best=False)
    np.testing.assert_allclose(final_scores, np.asarray(jax_last.predict(jax_last.data.test[0])), rtol=0,
                               atol=SCORE_TOL)
    test_row = ours.test()
    # after serving the final parameters, best is served again, and back
    for _ in range(2):
        again = ours.recommend(k=5)
        np.testing.assert_array_equal(again[DEFAULT_PREDICTION_COL], first[DEFAULT_PREDICTION_COL])
        np.testing.assert_array_equal(ours.predict(frame, use_best=False), final_scores)
    assert ours.test() == test_row
    u, _ = ours.model.user_item_embeddings_trimmed()
    exported = np.load(ours.export_embeddings(str(tmp_path / "final.npz"), use_best=False))
    assert not np.array_equal(exported["user_emb"], u.detach().numpy())


def test_load_on_a_trained_recommender_restores_the_engine_state(fast_split, tmp_path):
    split, _ = fast_split
    _, ours = _trained_mf(tmp_path, split)
    best = ours.recommend(k=5)
    final = ours.recommend(k=5, use_best=False)
    ours.load(ours.engine.checkpoint_dir)  # the best checkpoint becomes the engine's state
    np.testing.assert_array_equal(ours.recommend(k=5, use_best=False)[DEFAULT_ITEM_COL], best[DEFAULT_ITEM_COL])
    np.testing.assert_array_equal(ours.recommend(k=5)[DEFAULT_ITEM_COL], best[DEFAULT_ITEM_COL])
    ours.load(os.path.join(ours.engine.checkpoint_dir, "last"))
    np.testing.assert_array_equal(ours.recommend(k=5, use_best=False)[DEFAULT_ITEM_COL], final[DEFAULT_ITEM_COL])
    assert int(ours.engine.generator.initial_seed()) == 1


@pytest.mark.parametrize("key, value, item", [
    ("model", {"tune": True}, "item 9"),
    ("system", {"log_to_file": True}, "item 9"),
    ("system", {"checkpoint_backend": "orbax"}, "orbax"),
])
def test_fault_one_keys_raise(fast_split, tmp_path, key, value, item):
    """The keys that once raised citing ROADMAP item 9 work: ``model.tune``
    trains the config's grid and writes its table, ``system.log_to_file``
    tees the run's output into its log files. The orbax backend raises."""
    split, _ = fast_split
    cfg = Config({"model": {"model": "MF", "emb_dim": 4, "max_epoch": 1}, "system": {"root_dir": str(tmp_path)},
                  "dataset": {}, "tunable": [{"name": "lr", "type": "choice", "values": [0.1, 0.05]}]})
    cfg = cfg.replace(**{key: value})
    recommender = recommenders.MatrixFactorization(cfg, device="cpu")
    if item != "item 9":
        with pytest.raises(NotImplementedError, match=item):
            recommender.train(BaseData(split))
        return
    result = recommender.train(BaseData(split))
    assert np.isfinite(result["valid_metric"])
    if key == "model":
        assert [row["lr"] for row in result["tune_result"]] == [0.1, 0.05]
        assert os.path.exists(os.path.join(str(tmp_path), "tune_results", "tune_result.csv"))
        return
    recommender.engine.run_logger.restore()
    with open(recommender.engine.run_logger.stdout_path) as f:
        assert "[Epoch 0]" in f.read()


def test_orbax_raises_on_load_and_flax_stays_valid(fast_split, tmp_path):
    split, _ = fast_split
    data = BaseData(split)
    cfg, path = _mf_checkpoint(tmp_path, data)
    with pytest.raises(NotImplementedError, match="orbax"):
        recommenders.MatrixFactorization(cfg.replace(system={"checkpoint_backend": "orbax"}), device="cpu").load(
            path, data)
    os.makedirs(tmp_path / "only_orbax" / "orbax_state")
    save_metadata(str(tmp_path / "only_orbax"), load_metadata(path))
    with pytest.raises(NotImplementedError, match="orbax"):
        recommenders.MatrixFactorization(cfg, device="cpu").load(str(tmp_path / "only_orbax"), data)
    flax_cfg = cfg.replace(system={"checkpoint_backend": "flax"}, model={"max_epoch": 1})
    rec = recommenders.MatrixFactorization(flax_cfg, device="cpu")
    rec.train(data)
    assert rec.engine.has_checkpoint("last")


@pytest.mark.parametrize("config", sorted(f for f in os.listdir(os.path.join(REPO, "configs")) if f.endswith(".json")))
def test_every_shipped_config_passes_the_fault_one_checks(config, tmp_path):
    """No shipped config sets a key that raises: each builds an engine."""
    cfg = load_config(os.path.join(REPO, "configs", config)).replace(system={"root_dir": str(tmp_path)})
    assert not cfg.model.get("tune")
    TrainEngine(cfg, "cpu")
