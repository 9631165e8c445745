"""Pointwise (BCE) training in the port against the JAX package: the batches
an epoch forms (shapes, labels, each negative's user, rejection against the
train positives), one epoch of the pointwise trainer on batches the JAX code
formed against the JAX epoch function, the routing of ``TrainEngine.build``,
and end to end ``GMFRecommender``, ``MLPRecommender`` and ``NeuCF`` (cold
and warm-started) trained with ``device="cpu"``, whose best checkpoints the
JAX package loads and scores to the port's numbers."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from test_torch_train_mf import structured_split

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.train_engine import _padded_order as jax_padded_order
from beta_recsys_tpu.core.train_engine import make_epoch_fn as jax_make_epoch_fn
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.models.gmf import GMF as JaxGMF
from beta_recsys_tpu.models.mf import MF as JaxMF
from beta_recsys_tpu.models.mlp import MLP as JaxMLP
from beta_recsys_tpu.models.ncf import NeuMF as JaxNeuMF
from beta_recsys_tpu.recommenders import GMFRecommender as JaxGMFRecommender
from beta_recsys_tpu.recommenders import MLPRecommender as JaxMLPRecommender
from beta_recsys_tpu.recommenders import NeuCF as JaxNeuCF
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.convert import flatten_params, nest_dotted
from beta_recsys_tpu_torch.core.checkpoint import load_raw_checkpoint
from beta_recsys_tpu_torch.core.train_engine import (
    PointwiseEpochTrainer,
    TrainEngine,
    make_epoch_fn,
    make_negative_sampler,
    make_optimizer,
)
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.models import build_model
from beta_recsys_tpu_torch.recommenders import GMFRecommender, MLPRecommender, NeuCF
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_USER_COL

# float32 Adam over a few steps, gradients summed in other orders on the two
# sides (the JAX lookups' one-hot-matmul backward): a few ulp a step.
TOL = 1e-5
D, NUM_NEG, BATCH, LR = 8, 4, 128, 0.01

JAX_MODELS = {"GMF": JaxGMF, "MLP": JaxMLP, "NCF": JaxNeuMF, "MF": JaxMF}


@pytest.fixture(scope="module")
def split():
    return structured_split()


def _both_data(split):
    train, valid, test = split
    return BaseData(split), JaxBaseData((pd.DataFrame(train), [pd.DataFrame(f) for f in valid],
                                         [pd.DataFrame(f) for f in test]))


def _model_config(name, **extra):
    return {"model": name, "emb_dim": D, "mlp_config": {"n_layers": 2}, "dropout": 0.0, "stddev": 0.3,
            "num_negative": NUM_NEG, "loss": "bce", "lr": LR, "optimizer": "adam", **extra}


def _models(name, data, seed=0):
    """The JAX model and the port's on the JAX initializer's parameters."""
    cfg = _model_config(name)
    ref = JAX_MODELS[name](cfg, data.n_users, data.n_items)
    params = jax.tree_util.tree_map(np.asarray, ref.init_params(jax.random.key(seed)))
    ours = build_model(cfg, data.n_users, data.n_items, device="cpu")
    ours.load_state_dict(flatten_params(params))
    return cfg, ref, jax.tree_util.tree_map(jnp.asarray, params), ours


def jax_pointwise_batches(rng, jax_data, batch_size, num_neg):
    """The batches a JAX pointwise epoch forms from ``rng``, as
    ``make_epoch_fn`` forms them: (users, items, neg, labels)."""
    arrays = jax_data.train_arrays()
    n = len(arrays.users)
    num_batches = -(-n // batch_size)
    padded = num_batches * batch_size
    _, perm_key, k_neg, _ = jax.random.split(rng, 4)
    order = jax_padded_order(jax.random.permutation(perm_key, n), padded)
    users = jnp.asarray(arrays.users)[order]
    u_rep = jnp.broadcast_to(users[:, None], (padded, num_neg)).reshape(-1)
    neg = jax_make_negative_sampler(jax_data)(k_neg, u_rep, (padded * num_neg,))
    shape = (num_batches, batch_size)
    return (np.array(users).reshape(shape), np.array(jnp.asarray(arrays.items)[order]).reshape(shape),
            np.array(neg).reshape(num_batches, batch_size * num_neg),
            np.array(jnp.asarray(arrays.ratings)[order]).reshape(shape))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("name", ["GMF", "MLP", "NCF", "MF"])
def test_pointwise_epoch_matches_jax(split, name):
    """One epoch of 3 Adam steps (B 128 positives + 512 negatives) on the
    batches the JAX epoch forms, against the JAX epoch function: the loss,
    every parameter and Adam's moments."""
    data, jax_data = _both_data(split)
    cfg, ref, params, ours = _models(name, data)
    rng = jax.random.key(3)
    opt = optax.adam(LR)
    jax_epoch = jax_make_epoch_fn(ref, opt, jax_data.train_arrays(), BATCH,
                                  neg_sampler=jax_make_negative_sampler(jax_data), num_neg=NUM_NEG, donate=False)
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)
    want_params = flatten_params(jax.tree_util.tree_map(np.asarray, want_params))
    want_mu = flatten_params(jax.tree_util.tree_map(np.asarray, want_state[0].mu))
    want_nu = flatten_params(jax.tree_util.tree_map(np.asarray, want_state[0].nu))

    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = make_epoch_fn(ours, optimizer, data.train_arrays(), BATCH, make_negative_sampler(data, device="cpu"),
                            NUM_NEG)
    assert isinstance(trainer, PointwiseEpochTrainer)
    batches = jax_pointwise_batches(rng, jax_data, BATCH, NUM_NEG)
    assert trainer.num_batches == batches[0].shape[0] == 3
    _close(trainer.run_batches(*batches), want_loss)
    for pname, p in ours.named_parameters():
        _close(p, want_params[pname], pname)
        _close(optimizer.state[p]["exp_avg"], want_mu[pname], pname)
        _close(optimizer.state[p]["exp_avg_sq"], want_nu[pname], pname)
        assert int(optimizer.state[p]["step"]) == int(want_state[0].count) == 3


class _Recorder:
    """A model stand-in whose loss keeps each step's batch and the
    generator it was given."""

    batch_kind = "pointwise"

    def __init__(self):
        self.weight = torch.nn.Parameter(torch.zeros(()))
        self.batches = []

    def parameters(self):
        return iter([self.weight])

    def loss(self, batch, generator=None):
        self.batches.append((batch, generator))
        return self.weight * 0.0 + batch["labels"].mean()


def test_pointwise_batches_form_in_distribution(split):
    """Each epoch: every train row once (then wrapped to whole batches),
    labels the binarized ratings, ``num_neg`` negatives per positive drawn
    for that positive's user, rejected against the user's train positives
    (4 rounds, so a collision survives with probability (d/n)^5); each step
    trains on users cat(u, u repeated), items cat(it, neg), labels cat(r,
    0)."""
    data, _ = _both_data(split)
    sampler = make_negative_sampler(data, device="cpu")
    asked = []

    def recording_sampler(gen, users, shape):
        asked.append(users.clone())
        return sampler(gen, users, shape)

    model = _Recorder()
    trainer = PointwiseEpochTrainer(model, torch.optim.SGD(model.parameters(), lr=0.0), data.train_arrays(), BATCH,
                                    recording_sampler, NUM_NEG)
    arrays = data.train_arrays()
    train_pairs = sorted(zip(arrays.users.tolist(), arrays.items.tolist()))
    positive = data.pos_bitmask()
    gen = torch.Generator().manual_seed(0)
    draws_u, draws_i = [], []
    for _ in range(20):
        users, items, neg, labels = trainer.form(gen)
        nb = trainer.num_batches
        assert users.shape == items.shape == labels.shape == (nb, BATCH) and neg.shape == (nb, BATCH * NUM_NEG)
        flat_u, flat_i = users.reshape(-1), items.reshape(-1)
        assert sorted(zip(flat_u[:trainer.n].tolist(), flat_i[:trainer.n].tolist())) == train_pairs
        assert positive[flat_u.numpy(), flat_i.numpy()].all() and (labels == 1).all()
        assert torch.equal(asked[-1], flat_u.repeat_interleave(NUM_NEG))
        draws_u.append(asked[-1])
        draws_i.append(neg.reshape(-1))
    users, items = torch.cat(draws_u).numpy(), torch.cat(draws_i).numpy()
    assert items.min() >= 0 and items.max() < data.n_items
    share = positive.sum(axis=1) / data.n_items
    expected = (share[users] ** 5).sum()
    assert positive[users, items].sum() <= expected + 5 * np.sqrt(expected) + 1

    gen = torch.Generator().manual_seed(1)
    u, it, neg, r = trainer.form(gen)
    trainer.run_batches(u, it, neg, r, generator=gen)
    assert len(model.batches) == trainer.num_batches
    for b, (batch, given) in enumerate(model.batches):
        assert given is gen
        assert torch.equal(batch["users"], torch.cat([u[b], u[b].repeat_interleave(NUM_NEG)]))
        assert torch.equal(batch["items"], torch.cat([it[b], neg[b]]))
        assert torch.equal(batch["labels"], torch.cat([r[b], torch.zeros(BATCH * NUM_NEG)]))


def _config(root, name, seed=3, **model):
    return {
        "system": {"root_dir": str(root), "metrics": ["ndcg", "recall"], "k": [5, 10], "valid_metric": "ndcg",
                   "valid_k": 10, "seed": seed, "result_file": f"{name}_test.csv", "save_last_every": 5},
        "dataset": {"dataset": "synthetic", "data_split": "leave_one_out"},
        "model": {"model": name, "emb_dim": 16, "mlp_config": {"n_layers": 2}, "dropout": 0.1, "num_negative": 4,
                  "batch_size": 64, "optimizer": "adam", "lr": 0.02, "max_epoch": 12, "max_n_update": 10, **model},
    }


def test_build_reads_num_neg_as_jax_and_routes_the_pointwise_kind(split, tmp_path):
    data, _ = _both_data(split)
    for model, want in (({}, 4), ({"num_negative": 2}, 2)):
        raw = _config(tmp_path, "GMF", **model)
        if not model:
            del raw["model"]["num_negative"]
        cfg = Config(raw)
        engine = TrainEngine(cfg, "cpu").build(build_model(cfg.model, data.n_users, data.n_items, device="cpu"), data)
        assert isinstance(engine.epoch_fn, PointwiseEpochTrainer) and engine.epoch_fn.num_neg == want


def test_mesh_and_multineg_batches_raise(split, tmp_path):
    """NCF builds and trains an epoch on a (2, 1) mesh (the pointwise batch
    expanded on each data shard, tests/test_torch_mesh_dense.py holds it to
    JAX); a batch kind the dense trainer lacks raises."""
    data, _ = _both_data(split)
    cfg = Config(_config(tmp_path, "NCF", batch_size=63)).replace(system={"mesh": {"data": 2, "model": 1}})
    model = build_model(cfg.model, data.n_users, data.n_items, device="cpu")
    engine = TrainEngine(cfg, "cpu", mesh_devices=["cpu"] * 2).build(model, data, data.eval_candidates(data.valid[0]))
    assert isinstance(engine.epoch_fn, PointwiseEpochTrainer) and engine.epoch_fn.dp.mode == "data"
    assert engine.epoch_fn.batch_size == 62  # rounded down to the data axis, as the JAX package rounds it
    engine.train(max_epoch=1, verbose=False)
    assert [h["epoch"] for h in engine.bookkeeper.history] == [0] and engine.has_checkpoint("last")
    # Multineg batches train (tests/test_torch_train_multineg.py); a batch
    # kind the dense trainer lacks raises, as in the JAX package.
    with pytest.raises(ValueError, match="got none"):
        make_epoch_fn(types.SimpleNamespace(batch_kind="none"), None, data.train_arrays(), BATCH, None)


def test_neucf_takes_mesh_devices_and_its_mesh_raises(split, tmp_path):
    """NeuCF passes ``mesh_devices`` on to the base class, as every other
    recommender does, and trains on a (2, 2) mesh: the whole batch's loss,
    as the JAX package's partitioner computes it."""
    data, _ = _both_data(split)
    cfg = Config(_config(tmp_path, "NCF", max_epoch=1)).replace(system={"mesh": {"data": 2, "model": 2}})
    rec = NeuCF(cfg, device="cpu", mesh_devices=["cpu"] * 4)
    assert rec.mesh_devices == ["cpu"] * 4
    result = rec.train(data)
    assert rec.engine.epoch_fn.dp.mode == "model" and np.isfinite(result["valid_metric"])
    assert rec.engine.valid_evaluator.mesh is rec.engine.mesh


RECOMMENDERS = {"GMF": (GMFRecommender, JaxGMFRecommender), "MLP": (MLPRecommender, JaxMLPRecommender),
                "NCF": (NeuCF, JaxNeuCF)}


@pytest.fixture(scope="module")
def trained(split, tmp_path_factory):
    """GMF, MLP and NCF trained by the port on the CPU, and NCF once more,
    warm-started from the first two."""
    data, _ = _both_data(split)
    out = {}
    for name in ("GMF", "MLP", "NCF"):
        root = tmp_path_factory.mktemp(name)
        rec = RECOMMENDERS[name][0](Config(_config(root, name)), device="cpu")
        out[name] = (rec, rec.train(data), rec.test())
    root = tmp_path_factory.mktemp("warm")
    warm = NeuCF(Config(_config(root, "NCF")), gmf_params=nest_dotted(out["GMF"][0].model.state_dict()),
                 mlp_params=nest_dotted(out["MLP"][0].model.state_dict()), device="cpu")
    out["warm"] = (warm, warm.train(data), warm.test())
    return out


@pytest.mark.parametrize("name", ["GMF", "MLP", "NCF", "warm"])
def test_training_learns_and_the_jax_package_loads_the_checkpoint(split, trained, tmp_path, name):
    data, jax_data = _both_data(split)
    rec, result, ours = trained[name]
    # Random ranking over 21 candidates gives ndcg@10 ~0.20.
    assert result["valid_metric"] > 0.3 and ours["ndcg@10"] > 0.3, (result, ours)
    raw = load_raw_checkpoint(result["model_save_dir"])
    assert raw["opt_state"]["0"]["count"] > 0 and set(raw["opt_state"]["0"]["mu"]) == set(raw["params"])

    model_name = "NCF" if name == "warm" else name
    jax_cfg = JaxConfig(json.loads(json.dumps(_config(tmp_path / "jax", model_name))))
    ref = RECOMMENDERS[model_name][1](jax_cfg).load(result["model_save_dir"], jax_data)
    frame = {c: data.test[0][c][:150] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    np.testing.assert_allclose(rec.predict(frame), np.asarray(ref.predict(ref.data.test[0].iloc[:150])),
                               rtol=1e-6, atol=1e-6)
    want = ref.test()
    assert list(ours) == sorted(want)
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)


def test_warm_start_enters_training_with_the_given_tables(split, trained, tmp_path):
    """The warm-started NeuCF's initial GMF tables, MLP tables and layers are
    the pretrained models' bit for bit, from the port's trees and from the
    JAX checkpoints' trees alike."""
    data, _ = _both_data(split)
    gmf, mlp = (trained[n][0].model.state_dict() for n in ("GMF", "MLP"))
    checkpoints = (load_raw_checkpoint(trained[n][1]["model_save_dir"])["params"] for n in ("GMF", "MLP"))
    trees = {"port": (nest_dotted(gmf), nest_dotted(mlp)), "checkpoint": tuple(checkpoints)}
    for source, (g, m) in trees.items():
        rec = NeuCF(Config(_config(tmp_path, "NCF")), gmf_params=g, mlp_params=m, device="cpu")
        state = rec.init(data, torch.Generator().manual_seed(0)).model.state_dict()
        for side in ("user", "item"):
            assert torch.equal(state[f"{side}_emb_gmf"], gmf[f"{side}_emb"]), source
            assert torch.equal(state[f"{side}_emb_mlp"], mlp[f"{side}_emb"]), source
        for key in (k for k in mlp if k.startswith("layers.")):
            assert torch.equal(state[key], mlp[key]), (source, key)


def test_a_seed_repeats_bit_for_bit(split, tmp_path):
    """Two trainings of one seed (dropout 0.1) give the same best model and
    epoch. On one thread: the CPU's kernels may split a sum over threads in
    another order on another run (the card's sum in a fixed order)."""
    data, _ = _both_data(split)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = []
        for _ in range(2):
            rec = NeuCF(Config(_config(tmp_path, "NCF", max_epoch=5)), device="cpu")
            runs.append((rec.train(data), rec.model.state_dict()))
    finally:
        torch.set_num_threads(threads)
    (first, first_state), (again, again_state) = runs
    assert (again["best_epoch"], again["valid_metric"]) == (first["best_epoch"], first["valid_metric"])
    for key, value in first_state.items():
        assert torch.equal(again_state[key], value), key
