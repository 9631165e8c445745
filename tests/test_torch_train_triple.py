"""The triple trainer (Triple2vec, VBCAR, TVBR) of the port against the JAX
package at a small size: one epoch through ``run_batches`` on the order and
the negatives the JAX ``make_triple_epoch_fn`` forms from its key (VBCAR's
and TVBR's latent noise handed over), the epoch's draws in shape and
range, the triples drawn from the run's seed, ``XRecommender(cfg,
device="cpu").train(data)`` whose best checkpoint the JAX package loads and
tests to the port's metrics, a seed repeating bit for bit, a mesh of
several devices raising, and the JAX-trained Triple2vec checkpoint served
at the JAX package's ``test()``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from test_torch_train_sasrec import sequence_split

from beta_recsys_tpu import recommenders as jax_recommenders
from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.train_engine import _padded_order as jax_padded_order
from beta_recsys_tpu.core.train_engine import make_triple_epoch_fn as jax_make_triple_epoch_fn
from beta_recsys_tpu.data.grocery_data import GroceryData as JaxGroceryData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.datasets.synthetic import add_synthetic_baskets as jax_add_synthetic_baskets
from beta_recsys_tpu.models.triple2vec import Triple2vec as JaxTriple2vec
from beta_recsys_tpu.models.tvbr import TVBR as JaxTVBR
from beta_recsys_tpu.models.vbcar import VBCAR as JaxVBCAR
from beta_recsys_tpu.ops.sampling import alias_negatives as jax_alias_negatives
from beta_recsys_tpu_torch import recommenders
from beta_recsys_tpu_torch.config import Config, load_config
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.core.checkpoint import load_metadata, load_raw_checkpoint
from beta_recsys_tpu_torch.core.train_engine import TrainEngine, TripleEpochTrainer, alias_tables, make_optimizer
from beta_recsys_tpu_torch.data.grocery_data import GroceryData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.datasets.synthetic import add_synthetic_baskets
from beta_recsys_tpu_torch.models import build_model
from beta_recsys_tpu_torch.models import vbcar as port_vbcar
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_PREDICTION_COL, DEFAULT_USER_COL

TOL = 1e-5
N_SAMPLE, BATCH, N_NEG, TIME_STEP = 300, 64, 3, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
CHECKPOINT = os.path.join(REPO, "parity_runs/checkpoints/Triple2vec_default_20260821_165054_qjaaht")
# The JAX package's Triple2vec(...).load(CHECKPOINT, data).test() on the
# structured split with its synthetic baskets.
EXPECTED = {"ndcg@10": 0.254779, "recall@10": 0.541888, "precision@10": 0.054189, "map@10": 0.169399}

MODEL_CFG = {
    "Triple2vec": {"model": "Triple2vec", "emb_dim": 8, "n_neg": N_NEG, "n_sample": N_SAMPLE, "use_bias": True},
    "VBCAR": {"model": "VBCAR", "emb_dim": 8, "late_dim": 6, "n_neg": N_NEG, "n_sample": N_SAMPLE, "alpha": 0.2,
              "activator": "tanh"},
    "TVBR": {"model": "TVBR", "emb_dim": 8, "late_dim": 6, "n_neg": N_NEG, "n_sample": N_SAMPLE, "alpha": 0.2,
             "activator": "tanh", "time_step": TIME_STEP},
}
JAX_MODELS = {"Triple2vec": JaxTriple2vec, "VBCAR": JaxVBCAR, "TVBR": JaxTVBR}


@pytest.fixture(scope="module")
def both():
    """(split with baskets, port GroceryData, JAX GroceryData)."""
    train, valid, test = sequence_split()
    split = (add_synthetic_baskets(train, 3), valid, test)
    jax_split = (jax_add_synthetic_baskets(pd.DataFrame(train), 3), [pd.DataFrame(f) for f in valid],
                 [pd.DataFrame(f) for f in test])
    return split, GroceryData(split), JaxGroceryData(jax_split)


def _features(data, name):
    if name == "Triple2vec":
        return None
    user_fea, item_fea = data.user_item_features(emb_dim=MODEL_CFG[name]["late_dim"])
    return {"user_fea": user_fea, "item_fea": item_fea}


@pytest.mark.parametrize("name,user_weighted", [("Triple2vec", False), ("Triple2vec", True), ("VBCAR", False),
                                                ("TVBR", False)])
def test_one_epoch_matches_jax(both, monkeypatch, name, user_weighted):
    """The JAX epoch's order (a permutation wrapped to whole batches) and
    alias-table negatives, handed to the port's trainer, give the JAX
    epoch's mean loss, parameters and Adam state."""
    _, data, jax_data = both
    cfg = {**MODEL_CFG[name], "lr": 0.01, "optimizer": "adam"}
    art = _features(data, name)
    ref = JAX_MODELS[name](cfg, data.n_users, data.n_items, art)
    params = ref.init_params(jax.random.key(1))
    time_step = cfg.get("time_step", 0)
    triples = data.sample_triples(N_SAMPLE, time_step=time_step, seed=4)
    n = len(triples["users"])
    num_batches = -(-n // BATCH)
    assert n % BATCH  # the wrap is exercised

    def alias(col, size):
        freq = np.bincount(jax_data.train[col].to_numpy(), minlength=size).astype(np.float64)
        from beta_recsys_tpu.utils.alias_table import AliasTable as JaxAliasTable

        table = JaxAliasTable(list(freq))
        return jnp.asarray(table.prob_arr, jnp.float32), jnp.asarray(table.alias_arr, jnp.int32)

    user_alias = alias(DEFAULT_USER_COL, data.n_users) if user_weighted else None
    item_alias = alias(DEFAULT_ITEM_COL, data.n_items)
    opt = optax.adam(cfg["lr"])
    rng = jax.random.key(7)
    _, perm_key, k1, k2, k3, k_epoch = jax.random.split(rng, 6)
    order = jax_padded_order(jax.random.permutation(perm_key, n), num_batches * BATCH).reshape(num_batches, BATCH)
    shape = (num_batches, BATCH, N_NEG)
    neg_users = (jax_alias_negatives(k1, shape, *user_alias) if user_weighted
                 else jax.random.randint(k1, shape, 0, data.n_users, dtype=jnp.int32))
    neg_item1, neg_item2 = (jax_alias_negatives(k, shape, *item_alias) for k in (k2, k3))
    jax_epoch = jax_make_triple_epoch_fn(ref, opt, triples, BATCH, data.n_users, data.n_items, N_NEG, donate=False,
                                         user_alias=user_alias, item_alias=item_alias)
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)

    if name != "Triple2vec":  # each step's six draws from its key, in the JAX order
        noise = []
        for k in jax.random.split(k_epoch, num_batches):
            keys = jax.random.split(k, 6)
            noise += [torch.from_numpy(np.array(jax.random.normal(keys[i], (BATCH, cfg["emb_dim"]) if i < 3
                                                                  else (BATCH, N_NEG, cfg["emb_dim"]))))
                      for i in range(6)]
        monkeypatch.setattr(port_vbcar, "latent_noise", lambda gen, shape, device: noise.pop(0))
    ours = build_model(cfg, data.n_users, data.n_items, art, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = TripleEpochTrainer(ours, optimizer, triples, BATCH, data.n_users, data.n_items, N_NEG)
    assert (trainer.num_batches, trainer.batch_size) == order.shape
    loss = trainer.run_batches(*(np.array(x) for x in (order, neg_users, neg_item1, neg_item2)),
                               generator=torch.Generator().manual_seed(0))
    if name != "Triple2vec":
        assert not noise
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL, atol=TOL)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want_params))
    mu = flatten_params(jax.tree_util.tree_map(np.asarray, want_state[0].mu))
    for key, p in ours.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), rtol=TOL, atol=TOL, err_msg=key)
        state = optimizer.state.get(p)
        if state:
            np.testing.assert_allclose(state["exp_avg"].numpy(), mu[key].numpy(), rtol=TOL, atol=1e-6, err_msg=key)
            assert int(state["step"]) == int(want_state[0].count) == num_batches
        else:  # the tied item_emb2: no gradient, optax's moments stay 0
            assert key == "item_emb2" and not mu[key].any() and torch.equal(p, torch.as_tensor(want[key].numpy()))


def test_the_epoch_draws(both):
    """``form``: the order is a permutation wrapped to whole batches; users
    are drawn uniformly unless weighted, items from the alias table (an
    item never in train is never drawn); a batch carries the triples of
    its order and the draws."""
    _, data, _ = both
    cfg = {**MODEL_CFG["TVBR"], "lr": 0.01}
    ours = build_model(cfg, data.n_users, data.n_items, _features(data, "TVBR"), device="cpu")
    triples = data.sample_triples(N_SAMPLE, time_step=TIME_STEP, seed=4)
    item_alias = alias_tables(data.train[DEFAULT_ITEM_COL], data.n_items + 5, "cpu")  # 5 items never seen
    trainer = TripleEpochTrainer(ours, None, triples, BATCH, data.n_users, data.n_items + 5, N_NEG,
                                 item_alias=item_alias)
    order, nu, ni1, ni2 = trainer.form(torch.Generator().manual_seed(3))
    n = len(triples["users"])
    flat = order.reshape(-1)
    assert torch.equal(torch.sort(flat[:n]).values, torch.arange(n))
    assert torch.equal(flat[n:], flat[: trainer.padded_size - n])
    for draw, size in ((nu, data.n_users), (ni1, data.n_items), (ni2, data.n_items)):
        assert draw.shape == (trainer.num_batches, BATCH, N_NEG) and draw.dtype == torch.long
        assert int(draw.min()) >= 0 and int(draw.max()) < size
    assert not torch.equal(ni1, ni2)
    batch = trainer.batch(order[0], nu[0], ni1[0], ni2[0])
    assert set(batch) == {"users", "item1", "item2", "t", "neg_users", "neg_item1", "neg_item2"}
    for key in ("users", "item1", "item2", "t"):
        assert np.array_equal(batch[key].numpy(), triples[key][order[0].numpy()])
    with pytest.raises(ValueError, match="empty training set for basket triples"):
        TripleEpochTrainer(ours, None, {key: v[:0] for key, v in triples.items()}, BATCH, 1, 1, N_NEG)


def _config(root, name, **model):
    return {
        "system": {"root_dir": str(root), "metrics": ["ndcg", "recall"], "k": [5, 10], "valid_metric": "ndcg",
                   "valid_k": 10, "seed": 5, "result_file": f"{name}_test.csv", "save_last_every": 2},
        "dataset": {"dataset": "synthetic", "data_split": "leave_one_out"},
        "model": {**MODEL_CFG[name], "batch_size": BATCH, "optimizer": "adam", "lr": 0.01, "max_epoch": 3,
                  "max_n_update": 10, **model},
    }


@pytest.mark.parametrize("name", list(MODEL_CFG))
def test_training_runs_and_the_jax_package_loads_the_checkpoint(both, tmp_path, name):
    """``XRecommender(cfg, device="cpu").train(data)``: triples drawn from the
    run's seed, the epochs, the best checkpoint with Adam's state in the JAX
    layout (zero moments for the tied item_emb2), and the JAX package's
    load() of it giving the port's test() and top-5 lists; a second run of
    the seed repeats the first bit for bit."""
    split, data, jax_data = both
    cls = getattr(recommenders, name)
    torch.set_num_threads(1)
    runs = []
    for sub in ("port", "again"):
        rec = cls(Config(_config(tmp_path / sub, name)), device="cpu")
        result = rec.train(GroceryData(split))
        runs.append((rec, result, rec.test()))
    (rec, result, ours), (again, again_result, again_ours) = runs
    assert len(rec.engine.bookkeeper.history) == 3 and 0 <= result["best_epoch"] < 3
    assert rec.engine.bookkeeper.history == again.engine.bookkeeper.history and ours == again_ours
    for key, value in rec.model.state_dict().items():
        assert torch.equal(value, again.model.state_dict()[key]), key
    want_triples = data.sample_triples(N_SAMPLE, time_step=MODEL_CFG[name].get("time_step", 0), seed=5)
    for key, values in rec.engine.epoch_fn.triples.items():
        assert np.array_equal(values.numpy(), want_triples[key])
    raw = load_raw_checkpoint(result["model_save_dir"])
    assert set(flatten_params(raw["opt_state"]["0"]["mu"])) == set(flatten_params(raw["params"]))
    assert int(raw["opt_state"]["0"]["count"]) == (result["best_epoch"] + 1) * rec.engine.epoch_fn.num_batches
    if name == "Triple2vec":
        assert not raw["opt_state"]["0"]["mu"]["item_emb2"].any()
        assert np.array_equal(raw["params"]["item_emb2"], rec.model.item_emb2.detach().numpy())

    jax_cls = getattr(jax_recommenders, name)
    ref = jax_cls(JaxConfig(json.loads(json.dumps(_config(tmp_path / "jax", name))))).load(
        result["model_save_dir"], jax_data)
    want = ref.test()
    assert list(ours) == sorted(want)
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    users = np.arange(10)
    got_rec, want_rec = rec.recommend(users=users, k=5), ref.recommend(users=users, k=5)
    np.testing.assert_array_equal(got_rec[DEFAULT_ITEM_COL], want_rec[DEFAULT_ITEM_COL].to_numpy())
    assert os.path.exists(os.path.join(result["model_save_dir"], "last", "checkpoint.msgpack"))


def test_a_mesh_of_several_devices_raises(both, tmp_path):
    """Triple2vec builds and trains an epoch on a (2, 1) mesh."""
    _, data, _ = both
    cfg = Config(_config(tmp_path, "Triple2vec")).replace(system={"mesh": {"data": 2, "model": 1}})
    model = build_model(cfg.model, data.n_users, data.n_items, device="cpu")
    engine = TrainEngine(cfg, "cpu", mesh_devices=["cpu"] * 2).build(model, data)
    assert engine.epoch_fn.dp.mode == "data" and engine.epoch_fn.batch_size % 2 == 0
    engine.train(max_epoch=1, verbose=False)
    assert engine.has_checkpoint("last") and all(torch.isfinite(p).all() for p in model.parameters())


def test_the_triple2vec_checkpoint_serves_the_jax_metrics(tmp_path):
    """The JAX-trained seed-0 Triple2vec checkpoint on the structured split
    with its synthetic baskets: the port's test() gives the JAX package's
    metrics, predict() its pair scores and recommend() its top-10 lists."""
    train, valid, test = load_split_data(SPLIT, n_test=1)
    data = GroceryData((add_synthetic_baskets(train), valid, test))
    cfg = load_config(CHECKPOINT).replace(system={"root_dir": str(tmp_path / "port")})
    ours = recommenders.Triple2vec(cfg, device="cpu").load(CHECKPOINT, data)
    got = ours.test()
    raw = load_metadata(CHECKPOINT)["config"]
    raw["system"]["root_dir"] = str(tmp_path / "jax")
    jtrain, jvalid, jtest = jax_load_split_data(SPLIT, n_test=1)
    ref = jax_recommenders.Triple2vec(JaxConfig(raw)).load(
        CHECKPOINT, JaxGroceryData((jax_add_synthetic_baskets(jtrain), jvalid, jtest)))
    want = ref.test()
    for key, value in EXPECTED.items():
        assert abs(want[key] - value) < 1e-6 and abs(got[key] - value) < 1e-6, key
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)
    pairs = {c: data.test[0][c][:200] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    np.testing.assert_allclose(ours.predict(pairs), ref.predict(pd.DataFrame(pairs)), rtol=1e-6, atol=1e-7)
    got_rec, want_rec = ours.recommend(k=10), ref.recommend(k=10)
    np.testing.assert_array_equal(got_rec[DEFAULT_ITEM_COL], want_rec[DEFAULT_ITEM_COL].to_numpy())
    np.testing.assert_allclose(got_rec[DEFAULT_PREDICTION_COL], want_rec[DEFAULT_PREDICTION_COL].to_numpy(),
                               rtol=1e-6, atol=1e-7)
    assert ours.model.tie_items and set(load_raw_checkpoint(CHECKPOINT)["params"]) == {
        "user_emb", "item_emb1", "item_emb2", "user_bias", "item_bias"}
