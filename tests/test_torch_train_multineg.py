"""Multineg batches and rmsprop in the port against the JAX package, and the
PairwiseGMF, CMN, UltraGCN and MixGCF recommenders trained end to end:
``OptaxRMSprop`` against ``optax.rmsprop`` step by step and its checkpoint
state both ways; the multineg batches an epoch forms (shapes, each
negative's user, rejection against the train positives, the draw in
distribution); one UltraGCN epoch, one MixGCF epoch (the same dropped
edges, message masks and mixing seeds on both sides) and one CMN epoch with
rmsprop on batches the JAX code formed against the JAX epoch function; ``TrainEngine.build`` reading
``num_neg``; and ``XRecommender(cfg, device="cpu").train(data)`` for the four
models (CMN warm-started from the trained PairwiseGMF, with rmsprop), whose
best checkpoints the JAX package loads and scores to the port's numbers, a
seed repeating bit for bit on one thread."""

import inspect
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from test_torch_multineg_models import ULTRA, ultragcn_artifacts
from test_torch_train_mf import jax_epoch_batches, structured_split

import beta_recsys_tpu.models.mixgcf as jax_mixgcf
from beta_recsys_tpu import recommenders as jax_recommenders
from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.train_engine import _padded_order as jax_padded_order
from beta_recsys_tpu.core.train_engine import make_epoch_fn as jax_make_epoch_fn
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.models.cmn import CMN as JaxCMNModel
from beta_recsys_tpu.models.cmn import build_item_neighborhoods as jax_build_item_neighborhoods
from beta_recsys_tpu.models.mixgcf import MixGCF as JaxMixGCFModel
from beta_recsys_tpu.models.ultragcn import UltraGCN as JaxUltraGCNModel
from beta_recsys_tpu_torch import recommenders
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.convert import flatten_params, nest_dotted
from beta_recsys_tpu_torch.core.checkpoint import load_raw_checkpoint
from beta_recsys_tpu_torch.core.train_engine import (
    RMSPROP_DECAY,
    RMSPROP_EPS,
    DenseEpochTrainer,
    OptaxRMSprop,
    TrainEngine,
    make_epoch_fn,
    make_negative_sampler,
    make_optimizer,
)
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.models import build_model, mixgcf
from beta_recsys_tpu_torch.models.cmn import build_item_neighborhoods
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_USER_COL

# float32 optimizer steps, gradients summed in other orders on the two sides
# (the JAX lookups' one-hot-matmul backward): a few ulp a step.
TOL = 1e-5
BATCH, LR, NUM_NEG = 128, 0.01, 6
MIX = {"model": "MixGCF", "emb_dim": 8, "context_hops": 2, "l2": 1e-2, "n_negs": 3, "K": 2,
       "edge_dropout_rate": 0.1, "mess_dropout_rate": 0.2}


@pytest.fixture(scope="module")
def split():
    return structured_split()


def _both_data(split):
    train, valid, test = split
    return BaseData(split), JaxBaseData((pd.DataFrame(train), [pd.DataFrame(f) for f in valid],
                                         [pd.DataFrame(f) for f in test]))


def _close(got, want, what="", tol=TOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


# -- rmsprop --------------------------------------------------------------------


def test_rmsprop_matches_optax_step_by_step():
    """Six steps of given gradients against ``optax.rmsprop(lr)``; at one
    step a parameter has no gradient, which optax sees as a zero one."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 2, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    ours = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = make_optimizer({"optimizer": "rmsprop", "lr": 0.05}, list(ours.values()))
    assert isinstance(opt, OptaxRMSprop)
    ref = optax.rmsprop(0.05)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = ref.init(jax_params)
    for step in range(6):
        grads = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32) for k, s in shapes.items()}
        if step == 2:
            grads["b"] = np.zeros(shapes["b"], np.float32)
        for k, p in ours.items():
            p.grad = None if step == 2 and k == "b" else torch.tensor(grads[k])
        opt.step()
        updates, state = ref.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, p in ours.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_params[k]), rtol=1e-6, atol=1e-8,
                                       err_msg=f"{k} step {step}")
            np.testing.assert_allclose(opt.state[p]["nu"].numpy(), np.asarray(state[0].nu[k]), rtol=1e-6,
                                       atol=1e-8, err_msg=f"nu {k} step {step}")


def test_optimizer_names():
    p = [torch.nn.Parameter(torch.zeros(2))]
    assert isinstance(make_optimizer({"optimizer": "sgd"}, p), torch.optim.SGD)
    assert isinstance(make_optimizer({}, p), torch.optim.Adam)
    opt = make_optimizer({"optimizer": "rmsprop", "lr": 0.5, "momentum": 0.9, "grad_clip": 5.0}, p)
    assert opt.defaults == {"lr": 0.5}  # momentum and grad_clip unread, as in JAX
    defaults = inspect.signature(optax.rmsprop).parameters
    assert (RMSPROP_DECAY, RMSPROP_EPS) == (defaults["decay"].default, defaults["eps"].default)


# -- multineg batches ---------------------------------------------------------------


def jax_multineg_batches(rng, jax_data, batch_size, num_neg):
    """The batches a JAX multineg epoch forms from ``rng``, as
    ``make_epoch_fn`` forms them: (users, pos, neg (…, num_neg))."""
    arrays = jax_data.train_arrays()
    n = len(arrays.users)
    num_batches = -(-n // batch_size)
    padded = num_batches * batch_size
    _, perm_key, k_neg, _ = jax.random.split(rng, 4)
    order = jax_padded_order(jax.random.permutation(perm_key, n), padded)
    users = jnp.asarray(arrays.users)[order]
    neg = jax_make_negative_sampler(jax_data)(k_neg, users[:, None], (padded, num_neg))
    shape = (num_batches, batch_size)
    return (np.array(users).reshape(shape), np.array(jnp.asarray(arrays.items)[order]).reshape(shape),
            np.array(neg).reshape(*shape, num_neg))


class _Recorder:
    """A model stand-in whose loss keeps each step's batch."""

    batch_kind = "multineg"

    def __init__(self):
        self.weight = torch.nn.Parameter(torch.zeros(()))
        self.calls = []

    def parameters(self):
        return iter([self.weight])

    def loss(self, batch, generator=None):
        self.calls.append(batch)
        return self.weight * 0.0 + batch["neg_items"].float().mean()


@pytest.mark.parametrize("mode", ["bitmask", "csr", "uniform"])
def test_multineg_batches_are_formed_as_jax_forms_them(split, mode):
    """(num_batches, B) users and positives, every positive once an epoch
    (the permutation wrapped), (num_batches, B, num_neg) negatives owned by
    the positive's user; the rejection samplers return no train positive
    here (the split leaves each user 32 free items), and the draws cover the
    catalog uniformly but for the user's positives."""
    data, _ = _both_data(split)
    model = _Recorder()
    trainer = make_epoch_fn(model, torch.optim.SGD(model.parameters(), lr=0.0), data.train_arrays(), BATCH,
                            make_negative_sampler(data, mode, device="cpu"), NUM_NEG)
    assert isinstance(trainer, DenseEpochTrainer) and trainer.neg_shape == (NUM_NEG,)
    gen = torch.Generator().manual_seed(0)
    users, pos, neg = trainer.form(gen)
    n = len(data.train_arrays().users)
    assert users.shape == pos.shape == (trainer.num_batches, BATCH) and neg.shape == (*users.shape, NUM_NEG)
    pairs = set(zip(data.train_arrays().users.tolist(), data.train_arrays().items.tolist()))
    seen = set(zip(users.reshape(-1)[:n].tolist(), pos.reshape(-1)[:n].tolist()))
    assert seen == pairs
    bitmask = torch.as_tensor(data.pos_bitmask())
    hits = bitmask[users[..., None].expand_as(neg), neg]
    if mode == "uniform":
        assert hits.any()
    else:
        assert not hits.any()
    counts = torch.bincount(torch.cat([trainer.form(gen)[2].reshape(-1) for _ in range(20)]),
                            minlength=data.n_items).double()
    free = (~bitmask).sum(0).double() if mode != "uniform" else torch.full((data.n_items,), 1.0)
    expected = counts.sum() * free / free.sum() if mode == "uniform" else None
    if expected is not None:
        assert ((counts - expected).abs() < 5 * expected.sqrt() + 1).all()
    else:  # each item drawn in proportion to the users it is free for
        share = (counts / counts.sum()) / (free / free.sum())
        assert (share - 1).abs().max() < 0.15
    trainer.run(gen)
    assert len(model.calls) == trainer.num_batches and model.calls[0]["neg_items"].shape == (BATCH, NUM_NEG)


def _multineg_models(data, cfg, seed=0):
    if cfg["model"] == "UltraGCN":
        artifacts, cls = ultragcn_artifacts(data, cfg["ii_neighbor_num"]), JaxUltraGCNModel
    else:
        artifacts, cls = {"adj": data.get_norm_adj("sym")}, JaxMixGCFModel
    ref = cls(cfg, data.n_users, data.n_items, artifacts)
    params = ref.init_params(jax.random.key(seed))
    ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    return ref, params, ours


def _inject_constant_mixgcf_draws(monkeypatch, ref, ours, n_nodes, seed=5):
    """The same dropped edges, message masks and mixing seeds at every step
    on both sides: the JAX epoch's scan traces its step once, so its draws
    are the same arrays at every step; the port's cycle through them."""
    rng = np.random.default_rng(seed)
    vals = ours.prop.vals.numpy()
    keep_e, rate_m, hops = 1 - ref.edge_dropout_rate, ref.mess_dropout_rate, ref.n_hops
    edges = [np.where(rng.uniform(size=vals.shape) < keep_e, vals / keep_e, 0.0).astype(np.float32)
             for _ in range(hops)]
    masks = [rng.uniform(size=(n_nodes, ref.emb_dim)) >= rate_m for _ in range(hops)]
    seeds = [rng.uniform(size=(BATCH, 1, hops + 1, 1)).astype(np.float32) for _ in range(ref.K)]
    jax_e, jax_m, jax_s = iter(edges), iter(masks), iter(seeds)
    uniform = jax.random.uniform
    monkeypatch.setattr(jax_mixgcf, "edge_dropout", lambda key, v, keep: jnp.asarray(next(jax_e)))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(next(jax_m)))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(next(jax_s))
                        if tuple(shape) == seeds[0].shape else uniform(key, shape, *a, **k))
    port_e, port_m, port_s = itertools.cycle(edges), itertools.cycle(masks), itertools.cycle(seeds)
    monkeypatch.setattr(mixgcf, "edge_dropout", lambda gen, v, keep: torch.as_tensor(next(port_e)))
    monkeypatch.setattr(mixgcf, "inverted_dropout",
                        lambda gen, x, rate: torch.where(torch.as_tensor(next(port_m)), x / (1 - rate), 0.0))
    monkeypatch.setattr(mixgcf, "mixing_seeds", lambda gen, shape, device: torch.as_tensor(next(port_s)))


@pytest.mark.parametrize("case", ["UltraGCN-adam", "UltraGCN-rmsprop", "MixGCF-adam"])
def test_multineg_epoch_matches_jax(split, case, monkeypatch):
    """One epoch of 3 steps (B 128) on the batches the JAX epoch forms,
    against the JAX epoch function: the loss, every parameter and the
    optimizer's moments."""
    name, opt_name = case.split("-")
    data, jax_data = _both_data(split)
    cfg = dict(ULTRA, ii_neighbor_num=4, num_negative=NUM_NEG) if name == "UltraGCN" else MIX
    cfg = dict(cfg, optimizer=opt_name, lr=LR)
    ref, params, ours = _multineg_models(data, cfg)
    if name == "MixGCF":
        _inject_constant_mixgcf_draws(monkeypatch, ref, ours, data.n_users + data.n_items)
    num_neg = int(getattr(ours, "num_neg", cfg.get("num_negative", 4)))
    assert num_neg == int(getattr(ref, "num_neg", cfg.get("num_negative", 4)))
    rng = jax.random.key(3)
    opt = optax.adam(LR) if opt_name == "adam" else optax.rmsprop(LR)
    jax_epoch = jax_make_epoch_fn(ref, opt, jax_data.train_arrays(), BATCH,
                                  neg_sampler=jax_make_negative_sampler(jax_data), num_neg=num_neg, donate=False)
    batches = jax_multineg_batches(rng, jax_data, BATCH, num_neg)
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)
    want_params = flatten_params(jax.tree_util.tree_map(np.asarray, want_params))
    moments = {"exp_avg": "mu", "exp_avg_sq": "nu"} if opt_name == "adam" else {"nu": "nu"}
    want_moments = {key: flatten_params(jax.tree_util.tree_map(np.asarray, getattr(want_state[0], field)))
                    for key, field in moments.items()}

    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = make_epoch_fn(ours, optimizer, data.train_arrays(), BATCH, make_negative_sampler(data, device="cpu"),
                            num_neg)
    assert trainer.num_batches == 3 and batches[2].shape == (3, BATCH, num_neg)
    _close(trainer.run_batches(*batches, generator=torch.Generator()), want_loss, "loss")
    for pname, p in ours.named_parameters():
        _close(p, want_params[pname], pname)
        for key, want in want_moments.items():
            _close(optimizer.state[p][key], want[pname], f"{key} {pname}")


def test_cmn_rmsprop_epoch_matches_jax(split):
    """One epoch of 3 rmsprop steps of CMN (B 128 pairs) on the batches the
    JAX epoch forms, against the JAX epoch function: the loss, every
    parameter and rmsprop's nu."""
    data, jax_data = _both_data(split)
    cfg = {"model": "CMN", "emb_dim": 12, "hops": 2, "training_l2_lambda": 0.1, "optimizer": "rmsprop", "lr": LR}
    nb, nb_len = jax_build_item_neighborhoods(data.user_item_csr())
    artifacts = {"item_neighbors": nb, "item_nb_len": nb_len}
    ref = JaxCMNModel(cfg, data.n_users, data.n_items, artifacts)
    params = ref.init_params(jax.random.key(0))
    ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    rng = jax.random.key(3)
    opt = optax.rmsprop(LR)
    jax_epoch = jax_make_epoch_fn(ref, opt, jax_data.train_arrays(), BATCH,
                                  neg_sampler=jax_make_negative_sampler(jax_data), donate=False)
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)
    want_params = flatten_params(jax.tree_util.tree_map(np.asarray, want_params))
    want_nu = flatten_params(jax.tree_util.tree_map(np.asarray, want_state[0].nu))
    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = make_epoch_fn(ours, optimizer, data.train_arrays(), BATCH, make_negative_sampler(data, device="cpu"))
    assert trainer.num_batches == 3 and trainer.neg_shape == ()
    _close(trainer.run_batches(*jax_epoch_batches(rng, jax_data, BATCH)), want_loss, "loss")
    for pname, p in ours.named_parameters():
        _close(p, want_params[pname], pname)
        _close(optimizer.state[p]["nu"], want_nu[pname], f"nu {pname}")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRUCTURED = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
SHIPPED_CMN_STEPS = 4


def test_cmn_rmsprop_steps_at_the_shipped_width_match_jax():
    """Four rmsprop steps of CMN at configs/cmn_default.json's model (emb 50,
    2 hops, batch 128, lr 1e-3) on the structured split, whose item
    neighbourhoods are 614 users wide, against the JAX model's loss,
    ``jax.grad`` and ``optax.rmsprop`` on the same batches: each step's
    loss, every parameter and rmsprop's nu."""
    data = BaseData(load_split_data(STRUCTURED, n_test=1))
    with open(os.path.join(REPO, "configs/cmn_default.json")) as f:
        cfg = json.load(f)["model"]
    nb, nb_len = build_item_neighborhoods(data.user_item_csr())
    want_nb, want_len = jax_build_item_neighborhoods(data.user_item_csr())
    assert np.array_equal(nb, want_nb) and np.array_equal(nb_len, want_len) and nb.shape[1] == 614
    artifacts = {"item_neighbors": nb, "item_nb_len": nb_len}
    ref = JaxCMNModel(cfg, data.n_users, data.n_items, artifacts)
    params = ref.init_params(jax.random.key(0))
    ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    assert (ours.emb_dim, ours.hops) == (50, 2)
    batch_size, lr = int(cfg["batch_size"]), float(cfg["lr"])
    rng = np.random.default_rng(0)
    arrays = data.train_arrays()
    rows = rng.integers(0, len(arrays.users), (SHIPPED_CMN_STEPS, batch_size))
    users, pos = arrays.users[rows], arrays.items[rows]
    neg = rng.integers(0, data.n_items, (SHIPPED_CMN_STEPS, batch_size)).astype(np.int32)
    opt = optax.rmsprop(lr)

    @jax.jit
    def jax_step(params, state, batch):
        loss, grads = jax.value_and_grad(ref.loss)(params, batch, jax.random.key(1))
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    state = opt.init(params)
    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = make_epoch_fn(ours, optimizer, arrays, batch_size, make_negative_sampler(data, device="cpu"))
    for s in range(SHIPPED_CMN_STEPS):
        batch = {"users": users[s], "pos_items": pos[s], "neg_items": neg[s]}
        params, state, want_loss = jax_step(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        _close(trainer.run_batches(users[s:s + 1], pos[s:s + 1], neg[s:s + 1]), want_loss, f"loss {s}")
    want_params = flatten_params(jax.tree_util.tree_map(np.asarray, params))
    want_nu = flatten_params(jax.tree_util.tree_map(np.asarray, state[0].nu))
    for pname, p in ours.named_parameters():
        _close(p, want_params[pname], pname)
        _close(optimizer.state[p]["nu"], want_nu[pname], f"nu {pname}")


def test_build_reads_num_neg_as_jax(split, tmp_path):
    """``num_neg`` from the model (MixGCF: K * n_negs) or else the config's
    ``num_negative`` (UltraGCN), as the JAX ``TrainEngine.build`` reads it."""
    data, _ = _both_data(split)
    for rec, want in ((recommenders.MixGCF({"model": MIX}, device="cpu"), MIX["K"] * MIX["n_negs"]),
                      (recommenders.UltraGCN({"model": dict(ULTRA, num_negative=7)}, device="cpu"), 7)):
        rec.data = data
        model = rec._build_model(data.n_users, data.n_items)
        engine = TrainEngine(rec.config, "cpu").build(model, data)
        assert isinstance(engine.epoch_fn, DenseEpochTrainer) and engine.epoch_fn.neg_shape == (want,)


# -- the four recommenders trained end to end ------------------------------------------


def _config(root, name, seed=3, **model):
    base = {
        "PairwiseGMF": {"emb_dim": 16, "regs": [1e-4], "optimizer": "adam", "lr": 0.01},
        "CMN": {"emb_dim": 16, "hops": 2, "training_l2_lambda": 0.01, "optimizer": "rmsprop", "lr": 0.003,
                "momentum": 0.9, "grad_clip": 5.0},
        "UltraGCN": dict(ULTRA, num_negative=8, optimizer="adam", lr=0.01, stddev=1e-3),
        "MixGCF": dict(MIX, optimizer="adam", lr=0.01),
    }[name]
    return {
        "system": {"root_dir": str(root), "metrics": ["ndcg", "recall"], "k": [5, 10], "valid_metric": "ndcg",
                   "valid_k": 10, "seed": seed, "result_file": f"{name}_test.csv", "save_last_every": 4},
        "dataset": {"dataset": "synthetic", "data_split": "leave_one_out"},
        "model": {**base, "model": name, "batch_size": 64, "max_epoch": 6, "max_n_update": 6, **model},
    }


def _train(name, data, root, pretrained=None, **model):
    cls = {"PairwiseGMF": recommenders.PairwiseGMFRecommender, "CMN": recommenders.CMN,
           "UltraGCN": recommenders.UltraGCN, "MixGCF": recommenders.MixGCF}[name]
    cfg = Config(_config(root, name, **model))
    rec = cls(cfg, **(pretrained or {}), device="cpu")
    return rec, rec.train(data)


@pytest.fixture(scope="module")
def trained(split, tmp_path_factory):
    data, _ = _both_data(split)
    out = {}
    for name in ("PairwiseGMF", "CMN", "UltraGCN", "MixGCF"):
        pretrained = None
        if name == "CMN":
            gmf = out["PairwiseGMF"][0].model
            pretrained = {"user_embeddings": gmf.user_memory, "item_embeddings": gmf.item_memory}
        rec, result = _train(name, data, tmp_path_factory.mktemp(name), pretrained)
        out[name] = (rec, result, rec.test())
    return out


JAX_RECOMMENDERS = {"PairwiseGMF": jax_recommenders.PairwiseGMFRecommender, "CMN": jax_recommenders.CMN,
                    "UltraGCN": jax_recommenders.UltraGCN, "MixGCF": jax_recommenders.MixGCF}


@pytest.mark.parametrize("name", list(JAX_RECOMMENDERS))
def test_training_and_the_jax_package_loads_the_checkpoint(split, trained, tmp_path, name):
    data, jax_data = _both_data(split)
    rec, result, ours = trained[name]
    # Random ranking over 21 candidates gives ndcg@10 ~0.20; UltraGCN at
    # emb 16 and 6 epochs has not left its initial scores' scale yet.
    floor = 0.0 if name == "UltraGCN" else 0.3
    assert result["valid_metric"] > floor and ours["ndcg@10"] > floor and np.isfinite(list(ours.values())).all()
    raw = load_raw_checkpoint(result["model_save_dir"])
    state = raw["opt_state"]["0"]
    assert set(flatten_params(state["nu"])) == set(flatten_params(raw["params"]))
    if name == "CMN":
        assert set(state) == {"nu"} and raw["opt_state"]["1"] == raw["opt_state"]["2"] == {}
    else:
        assert state["count"] > 0

    jax_cfg = JaxConfig(json.loads(json.dumps(_config(tmp_path / "jax", name))))
    ref = JAX_RECOMMENDERS[name](jax_cfg).load(result["model_save_dir"], jax_data)
    frame = {c: data.test[0][c][:150] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    np.testing.assert_allclose(rec.predict(frame), np.asarray(ref.predict(ref.data.test[0].iloc[:150])),
                               rtol=1e-6, atol=1e-6)
    want = ref.test()
    assert list(ours) == sorted(want)
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)


def test_cmn_starts_from_the_pretrained_memories(split, trained, tmp_path):
    """CMN's first epoch starts from the PairwiseGMF's best memories bit for
    bit (its engine's initial parameters, before any step)."""
    data, _ = _both_data(split)
    gmf = trained["PairwiseGMF"][0].model
    rec = recommenders.CMN(Config(_config(tmp_path, "CMN")), user_embeddings=gmf.user_memory.detach().numpy(),
                           item_embeddings=gmf.item_memory, device="cpu")
    rec.data = data
    model = rec._build_model(data.n_users, data.n_items)
    TrainEngine(rec.config, "cpu").build(model, data)
    assert torch.equal(model.user_memory, gmf.user_memory) and torch.equal(model.item_memory, gmf.item_memory)


def test_a_jax_rmsprop_checkpoint_loads_in_the_port(split, tmp_path):
    """The JAX package trains CMN with rmsprop for 2 epochs; the port loads
    its best checkpoint and scores as the JAX package does, and the port's
    rmsprop state tree has the JAX checkpoint's structure and shapes."""
    data, jax_data = _both_data(split)
    raw_cfg = _config(tmp_path / "jax", "CMN", max_epoch=2)
    ref = jax_recommenders.CMN(JaxConfig(json.loads(json.dumps(raw_cfg))))
    result = ref.train(jax_data)
    jax_raw = load_raw_checkpoint(result["model_save_dir"])
    rec = recommenders.CMN(Config(raw_cfg), device="cpu").load(result["model_save_dir"], data)
    frame = {c: data.test[0][c][:150] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    np.testing.assert_allclose(rec.predict(frame), np.asarray(ref.predict(ref.data.test[0].iloc[:150])),
                               rtol=1e-6, atol=1e-6)
    want = ref.test()
    got = rec.test()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)

    port, port_result = _train("CMN", data, tmp_path / "port", max_epoch=2)
    port_raw = load_raw_checkpoint(port_result["model_save_dir"])
    shapes = lambda tree: {k: tuple(v.shape) for k, v in flatten_params(tree).items()}  # noqa: E731
    assert set(jax_raw["opt_state"]) == set(port_raw["opt_state"]) == {"0", "1", "2"}
    for key in ("1", "2"):
        assert jax_raw["opt_state"][key] == port_raw["opt_state"][key] == {}
    assert set(jax_raw["opt_state"]["0"]) == set(port_raw["opt_state"]["0"]) == {"nu"}
    assert shapes(jax_raw["opt_state"]["0"]["nu"]) == shapes(port_raw["opt_state"]["0"]["nu"])
    assert nest_dotted(shapes(port_raw["opt_state"]["0"]["nu"])).keys() == jax_raw["opt_state"]["0"]["nu"].keys()


@pytest.mark.parametrize("name", list(JAX_RECOMMENDERS))
def test_a_seed_repeats_bit_for_bit(split, tmp_path, name):
    """Two trainings of one seed for 2 epochs (MixGCF's dropouts and mixing
    on) give the same best model, last model and epoch metrics. On one
    thread: the CPU's kernels may split a sum over threads in another order
    on another run."""
    data, _ = _both_data(split)
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
