"""SimGCL, SGL, BUIR and LCFN training in the port against the JAX package:
one pairwise epoch of each on the batches the JAX epoch forms against the
JAX ``make_epoch_fn`` (the same draws on both sides; BUIR's target EMA after
every step, as the JAX step's ``post_update``), BUIR's target kept out of
the optimizer with zero moments in the checkpoint's optax state, and end to
end each recommender trained with ``device="cpu"``, whose best checkpoint
the JAX package cold-loads and scores to the port's numbers (LCFN over the
port's (P, Q) on both sides), BUIR's ``predict()`` raising in both packages,
and a seed repeating bit for bit."""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from test_torch_ssl_models import CONFIGS, artifacts_for, inject_sgl_draws
from test_torch_train_mf import jax_epoch_batches, structured_split

import beta_recsys_tpu.models.simgcl as jax_simgcl
from beta_recsys_tpu import recommenders as jax_recommenders
from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.train_engine import make_epoch_fn as jax_make_epoch_fn
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.models import MODEL_REGISTRY as JAX_MODELS
from beta_recsys_tpu_torch import recommenders
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.core.checkpoint import load_raw_checkpoint
from beta_recsys_tpu_torch.core.train_engine import make_epoch_fn, make_negative_sampler, make_optimizer
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.models import build_model, simgcl
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_USER_COL

# float32 Adam over a few steps, the propagations' sums in other orders on the
# two sides: a few ulp a step.
TOL = 1e-5
BATCH, LR = 128, 0.01
NAMES = ("SimGCL", "SGL", "BUIR", "LCFN")


@pytest.fixture(scope="module")
def split():
    return structured_split()


@pytest.fixture(scope="module")
def both_data(split):
    train, valid, test = split
    return BaseData(split), JaxBaseData((pd.DataFrame(train), [pd.DataFrame(f) for f in valid],
                                         [pd.DataFrame(f) for f in test]))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=TOL, atol=TOL, err_msg=what)


class _Overriding:
    """A module's attributes, some replaced."""

    def __init__(self, module, **replaced):
        self._module, self._replaced = module, replaced

    def __getattr__(self, name):
        return self._replaced[name] if name in self._replaced else getattr(self._module, name)


def inject_simgcl_noise(monkeypatch, ours, seed=9):
    """Both sides perturb with the same 2 * n_layers noise tables, in call
    order (the JAX model's ``jax.random.uniform`` alone replaced)."""
    n, d = ours.n_users + ours.n_items, ours.emb_dim
    rng = np.random.default_rng(seed)
    noise = [rng.uniform(size=(n, d)).astype(np.float32) for _ in range(2 * ours.n_layers)]
    port_noise, jax_noise = itertools.cycle(noise), itertools.cycle(noise)
    monkeypatch.setattr(simgcl, "perturbation_noise", lambda gen, shape, device: torch.as_tensor(next(port_noise)))
    fake_random = _Overriding(jax.random, uniform=lambda key, shape=(), *a, **k: jnp.asarray(next(jax_noise)))
    monkeypatch.setattr(jax_simgcl, "jax", _Overriding(jax, random=fake_random))


@pytest.mark.parametrize("name", NAMES)
def test_pairwise_epoch_matches_jax(both_data, name, monkeypatch):
    """One epoch of 3 Adam steps (B 128) on the batches the JAX epoch forms,
    against the JAX epoch function: the loss, every parameter (BUIR's target
    after its EMA each step) and Adam's moments."""
    data, jax_data = both_data
    key = "LCFN-2" if name == "LCFN" else name
    cfg = dict(CONFIGS[key], lr=LR, optimizer="adam")
    artifacts = artifacts_for(data, cfg)
    ref = JAX_MODELS[name](cfg, data.n_users, data.n_items, artifacts)
    params = ref.init_params(jax.random.key(0))
    ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    if name == "SGL":
        inject_sgl_draws(monkeypatch, data, ours, 2)
    elif name == "SimGCL":
        inject_simgcl_noise(monkeypatch, ours)

    rng = jax.random.key(3)
    opt = optax.adam(LR)
    jax_epoch = jax_make_epoch_fn(ref, opt, jax_data.train_arrays(), BATCH,
                                  neg_sampler=jax_make_negative_sampler(jax_data), donate=False)
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)
    want_params = flatten_params(jax.tree_util.tree_map(np.asarray, want_params))
    want_mu = flatten_params(jax.tree_util.tree_map(np.asarray, want_state[0].mu))
    want_nu = flatten_params(jax.tree_util.tree_map(np.asarray, want_state[0].nu))

    optimizer = make_optimizer(cfg, [p for p in ours.parameters() if p.requires_grad])
    trainer = make_epoch_fn(ours, optimizer, data.train_arrays(), BATCH, make_negative_sampler(data, device="cpu"))
    assert trainer.num_batches == 3
    _close(trainer.run_batches(*jax_epoch_batches(rng, jax_data, BATCH), generator=torch.Generator()), want_loss)
    for pname, p in ours.named_parameters():
        _close(p, want_params[pname], pname)
        if not p.requires_grad:  # BUIR's target: moved by the EMA alone, optax's moments stay 0
            assert p not in optimizer.state and not want_mu[pname].any() and not want_nu[pname].any()
            continue
        _close(optimizer.state[p]["exp_avg"], want_mu[pname], pname)
        _close(optimizer.state[p]["exp_avg_sq"], want_nu[pname], pname)
    if name == "BUIR":
        assert not np.array_equal(ours.target["user_emb"].detach().numpy(), np.asarray(params["target"]["user_emb"]))


def test_buir_post_update_follows_three_steps_as_jax(both_data):
    """Three Adam steps with the EMA after each, one batch a step, against
    the JAX model's loss, ``optax.adam`` and ``post_update`` (1e-6)."""
    data, _ = both_data
    cfg = dict(CONFIGS["BUIR"], lr=LR)
    artifacts = artifacts_for(data, cfg)
    ref = JAX_MODELS["BUIR"](cfg, data.n_users, data.n_items, artifacts)
    params = ref.init_params(jax.random.key(1))
    ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    opt = optax.adam(LR)
    state = opt.init(params)
    optimizer = make_optimizer(cfg, [p for p in ours.parameters() if p.requires_grad])
    trainer = make_epoch_fn(ours, optimizer, data.train_arrays(), 64, make_negative_sampler(data, device="cpu"))
    grad_fn = jax.jit(jax.grad(ref.loss))
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = {"users": rng.integers(0, data.n_users, 64), "pos_items": rng.integers(0, data.n_items, 64),
                 "neg_items": rng.integers(0, data.n_items, 64)}
        updates, state = opt.update(grad_fn(params, {k: jnp.asarray(v) for k, v in batch.items()}, None), state,
                                    params)
        params = ref.post_update(optax.apply_updates(params, updates))
        trainer.step(*(torch.as_tensor(batch[k]) for k in ("users", "pos_items", "neg_items")), None)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, params))
    for name, value in ours.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name], rtol=1e-6, atol=1e-6, err_msg=name)


def _config(root, name, seed=3, **model):
    key = "LCFN-1" if name == "LCFN" else name
    return {
        "system": {"root_dir": str(root), "metrics": ["ndcg", "recall"], "k": [5, 10], "valid_metric": "ndcg",
                   "valid_k": 10, "seed": seed, "result_file": f"{name}_test.csv", "save_last_every": 4},
        "dataset": {"dataset": "synthetic", "data_split": "leave_one_out"},
        "model": {**CONFIGS[key], "optimizer": "adam", "lr": 0.01, "batch_size": 64, "max_epoch": 5,
                  "max_n_update": 5, **model},
    }


def _train(name, data, root, **model):
    rec = getattr(recommenders, name)(Config(_config(root, name, **model)), device="cpu")
    return rec, rec.train(data)


@pytest.fixture(scope="module")
def trained(both_data, tmp_path_factory):
    out = {}
    for name in NAMES:
        rec, result = _train(name, both_data[0], tmp_path_factory.mktemp(name))
        out[name] = (rec, result, rec.test())
    return out


@pytest.mark.parametrize("name", NAMES)
def test_training_and_the_jax_package_loads_the_checkpoint(both_data, trained, tmp_path, name, monkeypatch):
    data, jax_data = both_data
    rec, result, ours = trained[name]
    # Random ranking over 21 candidates gives ndcg@10 ~0.20. SimGCL serves its
    # raw tables, which its loss reaches only through propagation: on this
    # split it ranks below random in the JAX package too.
    floor = {"SimGCL": 0.0, "LCFN": 0.22}.get(name, 0.3)
    assert result["valid_metric"] > floor and ours["ndcg@10"] > floor and np.isfinite(list(ours.values())).all()
    raw = load_raw_checkpoint(result["model_save_dir"])
    state = raw["opt_state"]["0"]
    assert state["count"] > 0
    assert set(flatten_params(state["mu"])) == set(flatten_params(state["nu"])) == set(flatten_params(raw["params"]))
    if name == "BUIR":  # the target's moments are optax's zeros, the online encoder's are not
        for tree in (state["mu"], state["nu"]):
            assert not any(np.any(v) for v in tree["target"].values())
            assert all(np.any(v) for v in tree["online"].values())
    if name == "LCFN":  # one (P, Q) for both packages: an eigenvector is free up to its sign
        monkeypatch.setattr(jax_data, "get_graph_embeddings", lambda cut_off=0.2, tol=1e-5: data.get_graph_embeddings(
            cut_off, tol))

    jax_cfg = JaxConfig(json.loads(json.dumps(_config(tmp_path / "jax", name))))
    ref = getattr(jax_recommenders, name)(jax_cfg).load(result["model_save_dir"], jax_data)
    frame = {c: data.test[0][c][:150] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    if name == "BUIR":
        with pytest.raises(NotImplementedError):
            rec.predict(frame)
        with pytest.raises(NotImplementedError):
            ref.predict(ref.data.test[0].iloc[:150])
    else:
        np.testing.assert_allclose(rec.predict(frame), np.asarray(ref.predict(ref.data.test[0].iloc[:150])),
                                   rtol=1e-6, atol=1e-6)
    want = ref.test()
    assert list(ours) == sorted(want)
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    recs = rec.recommend(k=5)
    assert len(recs[DEFAULT_ITEM_COL]) == 5 * data.n_users and np.isfinite(recs["col_prediction"]).all()


@pytest.mark.parametrize("name", NAMES)
def test_a_seed_repeats_bit_for_bit(both_data, tmp_path, name):
    """Two trainings of one seed for 2 epochs (SGL's and SimGCL's draws on)
    give the same best model, last model and epoch metrics. On one thread:
    the CPU's kernels may split a sum over threads in another order on
    another run."""
    data, _ = both_data
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = []
        for i in range(2):
            rec, result = _train(name, data, tmp_path / str(i), max_epoch=2)
            last = load_raw_checkpoint(result["model_save_dir"] + "/last")["params"]
            runs.append((result, rec.model.state_dict(), flatten_params(last), rec.engine.bookkeeper.history))
    finally:
        torch.set_num_threads(threads)
    (first, first_state, first_last, first_history), (again, again_state, again_last, again_history) = runs
    assert (again["best_epoch"], again["valid_metric"]) == (first["best_epoch"], first["valid_metric"])
    assert again_history == first_history
    for key, value in first_state.items():
        assert torch.equal(again_state[key], value) and torch.equal(again_last[key], first_last[key]), key


def test_a_mesh_of_several_devices_raises(both_data, tmp_path):
    """BUIR trains an epoch on a (2, 1) mesh: its target's EMA once a step."""
    cfg = Config(_config(tmp_path, "BUIR", max_epoch=1)).replace(system={"mesh": {"data": 2, "model": 1}})
    rec = recommenders.BUIR(cfg, device="cpu", mesh_devices=["cpu"] * 2)
    result = rec.train(both_data[0])
    assert rec.engine.epoch_fn.dp.mode == "data" and np.isfinite(result["valid_metric"])
    assert rec.engine.epoch_fn.optimizer is rec.engine.optimizer
