"""The engine on a device mesh against the JAX package: sharded evaluation
(``RankingEvaluator`` and ``FullCatalogEvaluator`` with a mesh equal to one
device's and to the JAX package's, the engine wiring its mesh into the
per-epoch evaluators and sharing one set of replicas between them, one
device's evaluation the metric means bit for bit, the per-user file
without the padded rows), MF
learning on a (4, 2) mesh, the "auto" route to the row-sharded sparse
trainer, sharded resume (2 + 2 epochs equal to 4 straight, bit for bit, on
(1, 2) sparse, (2, 1) and (2, 2) dense meshes; the JAX package resuming a
port mesh ``last/``; the port resuming a JAX (4, 2) ``last/`` and matching
JAX's next epoch on its draws) and the collective count of one step (the
counterpart of the JAX package's tests/test_comm_gate.py)."""

import csv
import os

import jax
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
from test_torch_mesh_dense import jax_mesh, port_mesh
from test_torch_resume import _jax_opt_tree
from test_torch_train_mf import structured_split
from test_torch_train_pointwise import jax_pointwise_batches

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.eval_engine import FullCatalogEvaluator as JaxFullCatalogEvaluator
from beta_recsys_tpu.core.eval_engine import RankingEvaluator as JaxRankingEvaluator
from beta_recsys_tpu.core.train_engine import TrainEngine as JaxTrainEngine
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.models import build_model as jax_build_model
from beta_recsys_tpu.models.mf import MF as JaxMF
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.core import eval_engine, train_engine
from beta_recsys_tpu_torch.core.checkpoint import load_raw_checkpoint
from beta_recsys_tpu_torch.core.eval_engine import FullCatalogEvaluator, RankingEvaluator
from beta_recsys_tpu_torch.core.train_engine import TrainEngine, make_epoch_fn, make_negative_sampler, make_optimizer
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.data.sequential_data import SequentialData
from beta_recsys_tpu_torch.models import build_model
from beta_recsys_tpu_torch.parallel.comm_analysis import collective_bytes, estimate_link_bytes
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_TIMESTAMP_COL, \
    DEFAULT_USER_COL


def _both(split):
    train, valid, test = split
    return BaseData(split), JaxBaseData((pd.DataFrame(train), [pd.DataFrame(f) for f in valid],
                                         [pd.DataFrame(f) for f in test]))


@pytest.fixture(scope="module")
def eval_setup():
    """61 users: not a multiple of the 8-wide data axis, so the padding and
    rescaling are exercised (the JAX tests/test_sharded_eval.py setup)."""
    data, jax_data = _both(structured_split(n_users=61, n_items=40, per_user=8))
    cfg = {"model": "MF", "emb_dim": 16, "loss": "bpr", "optimizer": "adam", "lr": 0.05, "reg": 0.0,
           "batch_size": 128}
    ref = JaxMF(cfg, data.n_users, data.n_items)
    params = ref.init_params(jax.random.key(0))
    ours = build_model(cfg, data.n_users, data.n_items, {}, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    return data, jax_data, ref, params, ours


def _same(got, want, rel=1e-5):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=rel), key


def test_ranking_evaluator_sharded_matches_single(eval_setup):
    data, jax_data, ref, params, ours = eval_setup
    cand = data.eval_candidates(data.valid[0])
    base = RankingEvaluator(ours, cand).evaluate()
    sharded = RankingEvaluator(ours, cand, mesh=port_mesh((8, 1)))
    assert sharded.users.shape[0] == 64 and sharded.n_real == 61
    _same(sharded.evaluate(), base, rel=1e-6)
    jax_cand = jax_data.eval_candidates(jax_data.valid[0])
    _same(sharded.evaluate(), JaxRankingEvaluator(ref, jax_cand, mesh=jax_mesh((8, 1))).evaluate(params))


def test_full_catalog_evaluator_sharded_matches_single(eval_setup):
    data, jax_data, ref, params, ours = eval_setup
    rng = np.random.default_rng(0)
    rel = sp.csr_matrix((np.ones(data.n_users), (np.arange(data.n_users), rng.integers(0, data.n_items,
                                                                                        data.n_users))),
                        shape=(data.n_users, data.n_items))
    users = np.arange(data.n_users)
    base = FullCatalogEvaluator(ours, users, rel, data.user_item_csr(), user_block=16).evaluate()
    sharded = FullCatalogEvaluator(ours, users, rel, data.user_item_csr(), user_block=15, mesh=port_mesh((4, 2)))
    assert sharded.user_block == 12
    _same(sharded.evaluate(), base, rel=1e-6)
    want = JaxFullCatalogEvaluator(ref, users, rel, jax_data.user_item_csr(), user_block=16,
                                   mesh=jax_mesh((4, 2))).evaluate(params)
    _same(sharded.evaluate(), want)


def _engine_config(root, mesh, seed=3, **model):
    return Config({"system": {"root_dir": str(root), "metrics": ["ndcg"], "k": [10], "valid_metric": "ndcg",
                              "valid_k": 10, "seed": seed, "mesh": mesh},
                   "dataset": {"dataset": "synthetic"},
                   "model": {"model": "MF", "loss": "bpr", "emb_dim": 16, "batch_size": 128, "optimizer": "adam",
                             "lr": 0.05, "max_epoch": 3, "max_n_update": 3, **model}})


def test_the_engine_wires_its_mesh_into_the_evaluators(eval_setup, tmp_path):
    data, _, _, _, _ = eval_setup
    cfg = _engine_config(tmp_path, {"data": 8, "model": 1})
    model = build_model(cfg.model, data.n_users, data.n_items, {}, "cpu")
    engine = TrainEngine(cfg, "cpu", mesh_devices=["cpu"] * 8).build(
        model, data, data.eval_candidates(data.valid[0]), data.eval_candidates(data.test[0]))
    assert engine.valid_evaluator.mesh is engine.mesh and engine.test_evaluator.mesh is engine.mesh
    result = engine.train(verbose=False)
    assert np.isfinite(result["valid_metric"])
    one = RankingEvaluator(model, data.eval_candidates(data.valid[0]), ("ndcg",), (10,)).evaluate()
    assert engine.valid_evaluator.evaluate() == pytest.approx(one, rel=1e-6)
    # The final test() scores on one device, as in the JAX package.
    seen = []
    real = train_engine.RankingEvaluator.__init__

    def spy(self, *args, **kwargs):
        seen.append(kwargs.get("mesh"))
        real(self, *args, **kwargs)

    train_engine.RankingEvaluator.__init__ = spy
    try:
        engine.test([data.eval_candidates(data.test[0])])
    finally:
        train_engine.RankingEvaluator.__init__ = real
    assert seen == [None]


def test_one_device_evaluation_is_the_metric_means_bit_for_bit(eval_setup):
    """Without a mesh the model's device is the evaluator's one shard: its
    float64 sum of means times rows, divided by the rows, gives the float32
    means back exactly."""
    data, _, _, _, ours = eval_setup
    cand = data.eval_candidates(data.valid[0])
    got = RankingEvaluator(ours, cand).evaluate()
    with torch.no_grad():
        scores = ours.score_candidates(torch.as_tensor(cand.users), torch.as_tensor(cand.items))
        out = eval_engine.ranking_metrics(scores, torch.as_tensor(cand.relevance), torch.as_tensor(cand.mask),
                                          ("ndcg", "precision", "recall", "map"), (5, 10, 20))
    assert got == {key: float(value) for key, value in out.items()}


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_the_evaluators_share_one_set_of_replicas(eval_setup, tmp_path, mesh):
    """The engine's valid and test evaluators score on one set of replicas:
    on a data axis the data-parallel step's own."""
    data, _, _, _, _ = eval_setup
    cfg = _engine_config(tmp_path, {"data": mesh[0], "model": mesh[1]})
    model = build_model(cfg.model, data.n_users, data.n_items, {}, "cpu")
    engine = TrainEngine(cfg, "cpu", mesh_devices=["cpu"] * (mesh[0] * mesh[1])).build(
        model, data, data.eval_candidates(data.valid[0]), data.eval_candidates(data.test[0]))
    assert engine.valid_evaluator.replicas is engine.test_evaluator.replicas
    assert (engine.valid_evaluator.replicas is getattr(engine.epoch_fn.dp, "replicas", None)) == (mesh[1] == 1)
    assert engine.valid_evaluator.replicas[model.device] is model


def test_the_per_user_file_drops_the_padded_rows(tmp_path):
    """11 users on a data axis of 4 pad to 12; the file holds the 11 real
    users' candidates, as the JAX package's tests/test_round3_fixes.py."""
    n_users, n_items, n_cand = 11, 24, 6
    model = build_model({"model": "MF", "emb_dim": 8, "loss": "bpr"}, n_users, n_items, {}, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)

    class Cand:
        users = np.arange(n_users, dtype=np.int32)
        items = rng.integers(0, n_items, (n_users, n_cand)).astype(np.int32)
        relevance = np.eye(n_cand, dtype=np.float32)[rng.integers(0, n_cand, n_users)]
        mask = np.ones((n_users, n_cand), bool)

    ev = RankingEvaluator(model, Cand(), metrics=("ndcg",), ks=(5,), mesh=port_mesh((4, 2)))
    assert ev.users.shape[0] == 12
    path = str(tmp_path / "per_user.csv")
    mean_row, _ = eval_engine.test_eval([ev], save_mode="per_user", per_user_file=path)
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == n_users * n_cand
    users = [int(r["col_user"]) for r in rows]
    assert sorted(set(users)) == list(range(n_users)) and all(users.count(u) == n_cand for u in range(n_users))
    one = RankingEvaluator(model, Cand(), metrics=("ndcg",), ks=(5,)).evaluate()
    assert mean_row["ndcg@5"] == pytest.approx(one["ndcg@5"], rel=1e-6)


def test_mf_on_a_4x2_mesh_learns(tmp_path):
    """The JAX package's test_engine_with_mesh_config: MF on a (4, 2) mesh
    trains, evaluates on the mesh and learns."""
    data = BaseData(structured_split())
    cfg = _engine_config(tmp_path, {"data": 4, "model": 2}, seed=5, max_epoch=10, max_n_update=10)
    model = build_model(cfg.model, data.n_users, data.n_items, {}, "cpu")
    engine = TrainEngine(cfg, "cpu", mesh_devices=["cpu"] * 8).build(model, data, data.eval_candidates(data.valid[0]))
    assert engine.mesh.shape == {"data": 4, "model": 2} and engine.epoch_fn.dp.mode == "model"
    result = engine.train(verbose=False)
    assert result["valid_metric"] > 0.3, result


def _toy_engine(tmp_path, emb_dim, mesh=None, sparse_override=None):
    """1000 users x 200 items, every id present: emb_dim alone sets the row
    tables' bytes (the JAX package's tests/test_round5_fixes.py toy)."""
    n, n_users, n_items = 2000, 1000, 200
    frame = {DEFAULT_USER_COL: np.arange(n) % n_users, DEFAULT_ITEM_COL: np.arange(n) % n_items,
             DEFAULT_RATING_COL: np.ones(n, np.float32), DEFAULT_TIMESTAMP_COL: np.arange(n)}
    data = BaseData((frame, [], []), intersect=False)
    system = {"root_dir": str(tmp_path), "metrics": ["ndcg"], "k": [10], "valid_metric": "ndcg", "valid_k": 10,
              "seed": 1}
    if mesh:
        system["mesh"] = mesh
    model = {"model": "MF", "emb_dim": emb_dim, "batch_size": 256, "loss": "bpr", "optimizer": "adam", "lr": 0.05,
             "max_epoch": 1, "max_n_update": 1}
    if sparse_override is not None:
        model["sparse_optim"] = sparse_override
    cfg = Config({"system": system, "dataset": {"dataset": "synthetic"}, "model": model})
    built = build_model(cfg.model, data.n_users, data.n_items, {}, "cpu")
    return TrainEngine(cfg, "cpu", mesh_devices=["cpu"] * 8).build(built, data)


@pytest.mark.parametrize("emb_dim,mesh,override,sparse", [
    (2048, {"data": 4, "model": 2}, None, True),  # 1200 rows x 2048 x 4 B = 9.8 MB of row tables
    (16, {"data": 4, "model": 2}, None, False),
    (2048, None, None, False),
    (2048, {"data": 4, "model": 2}, False, False),
])
def test_auto_sparse_routing(tmp_path, emb_dim, mesh, override, sparse):
    """The JAX package's tests/test_round5_fixes.py auto-routing cases: large
    row tables on a mesh of several devices route to the row-sharded sparse
    trainer, small ones, no mesh or an explicit false stay dense."""
    engine = _toy_engine(tmp_path, emb_dim, mesh, override)
    assert engine.sparse_optim is sparse
    assert engine.sharded is sparse and (sparse or mesh is None or engine.epoch_fn.dp.mode == "model")


# -- sharded resume ---------------------------------------------------------------


@pytest.fixture
def one_thread():
    """One thread: the CPU's sums run in one order in every run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wide_split():
    """1,030 users: user_emb reaches default_param_rule's 1,024 rows, so a
    model axis row-shards it (40 items stay whole)."""
    return structured_split(n_users=1030, n_items=40, per_user=6)


def _resume_config(root, mesh, **model):
    return Config({"model": {"model": "MF", "emb_dim": 8, "lr": 0.05, "batch_size": 256, "max_epoch": 4, **model},
                   "system": {"root_dir": str(root), "seed": 3, "mesh": mesh}, "dataset": {}})


def _mesh_engine(cfg, data):
    mesh = cfg.system.mesh
    model = build_model(cfg.model, data.n_users, data.n_items, {}, "cpu")
    return TrainEngine(cfg, "cpu", mesh_devices=["cpu"] * (mesh["data"] * mesh["model"])).build(
        model, data, data.eval_candidates(data.valid[0]))


def _mesh_state(engine):
    """Everything a mesh run carries from epoch to epoch, whole and placed."""
    out = {f"param/{k}": v.clone() for k, v in engine.model.state_dict().items()}
    for name, state in engine._param_states().items():
        for key, value in (state or {}).items():
            out[f"opt/{name}/{key}"] = torch.as_tensor(value).clone()
    trainer = engine.epoch_fn
    if engine.sharded:
        out["sparse/step"] = torch.tensor(trainer.step_count)
        for name, shards in trainer.tables.items():
            for d, row in enumerate(shards):
                for m, shard in enumerate(row):
                    out[f"shard/{name}/{d}/{m}"] = shard.clone()
                    out[f"moments/{name}/{d}/{m}"] = torch.stack(trainer.moments[name][d][m]).clone()
    else:
        for name, shards in trainer.dp.tables.items():
            for m, shard in enumerate(shards):
                out[f"shard/{name}/{m}"] = shard.detach().clone()
    out["generator"] = engine.generator.get_state()
    bk = engine.bookkeeper
    out["bookkeeper"] = torch.tensor([bk.best_valid_performance, bk.best_epoch, bk.n_no_update], dtype=torch.float64)
    return out


RESUMES = {
    "sparse-1x2": ({"data": 1, "model": 2}, {"sparse_optim": True}),
    "dense-2x1": ({"data": 2, "model": 1}, {"sparse_optim": False}),
    "dense-2x2": ({"data": 2, "model": 2}, {"sparse_optim": False}),
}


@pytest.mark.parametrize("case", list(RESUMES))
def test_sharded_resume_repeats_an_uninterrupted_run_bit_for_bit(case, wide_split, tmp_path, one_thread):
    mesh, model = RESUMES[case]
    data = BaseData(wide_split)
    cfg = _resume_config(tmp_path, mesh, **model)
    first = _mesh_engine(cfg, data)
    first.train(max_epoch=2, verbose=False)
    resumed = _mesh_engine(cfg, data)
    assert resumed.resume_training(first.checkpoint_dir) == 2
    resumed.train(verbose=False)
    straight = _mesh_engine(cfg, data)
    straight.train(verbose=False)
    if case == "dense-2x2":
        assert set(straight.epoch_fn.dp.tables) == {"user_emb"}
    got, want = _mesh_state(resumed), _mesh_state(straight)
    assert list(got) == list(want) and any(key.startswith("opt/") for key in want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert [h["epoch"] for h in resumed.bookkeeper.history] == [2, 3]
    # A mesh's checkpoint holds whole tables and moments (1,030 rows pad to
    # none on a model axis of 2), in the dense layout.
    raw = load_raw_checkpoint(os.path.join(straight.checkpoint_dir, "last"))
    assert raw["params"]["user_emb"].shape == raw["opt_state"]["0"]["mu"]["user_emb"].shape == (1030, 8)


def _jax_engine(cfg, jax_data, mesh):
    raw = cfg.to_dict()
    raw["system"]["mesh"] = mesh
    jcfg = JaxConfig(raw)
    model = jax_build_model(jcfg.model, jax_data.n_users, jax_data.n_items)
    return JaxTrainEngine(jcfg).build(model, jax_data, jax_data.eval_candidates(jax_data.valid[0]))


def test_jax_resumes_a_port_mesh_last_checkpoint(wide_split, tmp_path):
    data, jax_data = _both(wide_split)
    cfg = _resume_config(tmp_path / "port", {"data": 2, "model": 2}, sparse_optim=False)
    ours = _mesh_engine(cfg, data)
    ours.train(max_epoch=2, verbose=False)
    jax_cfg = _resume_config(tmp_path / "jax", {"data": 2, "model": 2}, sparse_optim=False)
    ref = _jax_engine(jax_cfg, jax_data, {"data": 2, "model": 2})
    assert ref.resume_training(ours.checkpoint_dir) == 2
    for key, value in flatten_params(jax.tree_util.tree_map(np.asarray, ref.params)).items():
        assert torch.equal(ours.model.state_dict()[key], value), key
    want = load_raw_checkpoint(os.path.join(ours.checkpoint_dir, "last"))["opt_state"]
    got = _jax_opt_tree(ref.opt_state)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    ref.train(max_epoch=3, verbose=False)
    assert [h["epoch"] for h in ref.bookkeeper.history] == [2]


def test_port_resumes_a_jax_4x2_last_checkpoint_and_follows_its_next_epoch(wide_split, tmp_path):
    """A JAX (4, 2) run of pointwise MF (its user_emb row-sharded), 1 epoch;
    the port resumes its last/ on a (4, 2) mesh with JAX's parameters and
    moments, then trains on the batches JAX's next epoch forms from the
    restored key and lands on JAX's second epoch (rtol 2e-5, atol 1e-5)."""
    data, jax_data = _both(wide_split)
    mesh = {"data": 4, "model": 2}
    cfg = _resume_config(tmp_path / "jax", mesh, sparse_optim=False, loss="bce", num_negative=2, batch_size=254)
    ref = _jax_engine(cfg, jax_data, mesh)
    ref.train(max_epoch=1, verbose=False)
    ckpt = ref.checkpoint_dir
    ours = _mesh_engine(_resume_config(tmp_path / "port", mesh, sparse_optim=False, loss="bce", num_negative=2,
                                       batch_size=254), data)
    assert ours.resume_training(ckpt) == 1
    assert ours.epoch_fn.batch_size == 252 and set(ours.epoch_fn.dp.tables) == {"user_emb"}
    for key, value in flatten_params(jax.tree_util.tree_map(np.asarray, ref.params)).items():
        assert torch.equal(ours.model.state_dict()[key], value), key
    states = ours._param_states()
    want = _jax_opt_tree(ref.opt_state)["0"]
    for name, state in states.items():
        np.testing.assert_array_equal(state["exp_avg"].numpy(), want["mu"][name])
        assert int(state["step"]) == int(want["count"])
    batches = jax_pointwise_batches(ref.rng, jax_data, 252, 2)
    loss = ours.epoch_fn.run_batches(*batches)
    ours.epoch_fn.dp.assemble()
    params, opt_state, _, want_loss = ref.epoch_fn(ref.params, ref.opt_state, ref.rng)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5, atol=1e-5)
    for key, value in flatten_params(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_allclose(ours.model.state_dict()[key].numpy(), value.numpy(), rtol=2e-5, atol=1e-5,
                                   err_msg=key)


# -- the collective count ------------------------------------------------------


def _assert_single_grad_allreduce(counts, pbytes, steps, allow_other_frac=0.15):
    assert "all_reduce" in counts, counts
    ar = counts["all_reduce"]
    assert ar["calls"] == steps, f"expected 1 gradient all-reduce a step, got {counts}"
    per_step = ar["bytes"] / steps
    assert pbytes * 0.98 <= per_step <= pbytes * 1.02 + 64, (ar, pbytes)  # the float parameters and the loss
    other = sum(v["bytes"] for k, v in counts.items() if k != "all_reduce")
    assert other <= pbytes * allow_other_frac * steps, counts


@pytest.fixture(scope="module")
def comm_data():
    return BaseData(structured_split(n_users=64, n_items=48, per_user=10))


COMM = {
    "MF": {"model": "MF", "emb_dim": 32, "loss": "bpr", "reg": 0.0},
    "LightGCN": {"model": "LightGCN", "emb_dim": 32, "layer_size": [32, 32], "regs": [1e-5], "keep_pro": 1.0},
    "NCF": {"model": "NCF", "emb_dim": 8, "mlp_config": {"n_layers": 2}, "num_negative": 2},
    "SASRec": {"model": "SASRec", "emb_dim": 32, "maxlen": 20, "num_blocks": 1, "num_heads": 2, "dropout_rate": 0.0,
               "l2_emb": 0.0},
}


@pytest.mark.parametrize("name", list(COMM))
def test_one_allreduce_a_step_of_the_parameter_bytes(comm_data, name):
    """On a (4, 1) mesh a step issues one all-reduce whose bytes are the
    float parameters' (and the loss's), every other collective at most 15%
    of them (the JAX package's tests/test_comm_gate.py bounds)."""
    cfg = dict(COMM[name], optimizer="adam", lr=0.05)
    mesh = port_mesh((4, 1))
    if name == "SASRec":
        data = SequentialData((comm_data.train, [], []), intersect=False)
        model = build_model(cfg, data.n_users, data.n_items, {}, device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        trainer = train_engine.SequenceEpochTrainer(model, make_optimizer(cfg, model.parameters()),
                                                    data.train_seq_arrays(20), 16,
                                                    make_negative_sampler(data, "bitmask", "cpu"), mesh)
    else:
        data = comm_data
        artifacts = {"adj": data.get_norm_adj("sym")} if name == "LightGCN" else {}
        model = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        trainer = make_epoch_fn(model, make_optimizer(cfg, model.parameters()), data.train_arrays(), 128,
                                make_negative_sampler(data, "bitmask", "cpu"), int(cfg.get("num_negative", 1)), mesh)
    generator = torch.Generator().manual_seed(1)
    batches = [x[:2] for x in trainer.form(generator)]
    assert batches[0].shape[0] == 2
    counts = collective_bytes(trainer.run_batches, *batches, generator=generator)
    pbytes = sum(p.numel() * p.element_size() for p in model.parameters() if p.is_floating_point())
    _assert_single_grad_allreduce(counts, pbytes, steps=2)
    link = estimate_link_bytes(counts, 4)
    assert link["all_reduce"] == int(counts["all_reduce"]["bytes"] * 1.5)


@pytest.mark.parametrize("name", ["mf", "lightgcn", "sgl", "sasrec", "vaecf"])
def test_a_replica_scores_as_its_model(comm_data, name):
    """``replica`` (a model's copy for another card of a mesh) copies a
    model built from a shipped config, its config shared, and scores as
    the model does; ``Replicas.sync`` brings it the model's new values."""
    from beta_recsys_tpu_torch.config import load_config
    from beta_recsys_tpu_torch.parallel.data_parallel import Replicas, replica

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                                   f"{name}_default.json")).model
    data = SequentialData((comm_data.train, [], []), intersect=False) if name == "sasrec" else comm_data
    rng = np.random.default_rng(0)
    artifacts = ({"adj": data.get_norm_adj("sym")} if name in ("lightgcn", "sgl") else
                 {"ctx": rng.integers(0, data.n_items + 1, (data.n_users, cfg["maxlen"]))} if name == "sasrec" else
                 {"user_rows": (data.user_item_csr().toarray() > 0).astype(np.float32)} if name == "vaecf" else {})
    model = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    copy = replica(model, torch.device("cpu"))
    assert copy is not model and copy.config is model.config
    users = torch.arange(4)
    with torch.no_grad():
        torch.testing.assert_close(copy.score_all(users), model.score_all(users), rtol=0, atol=0)
        next(model.parameters()).add_(1.0)
    replicas = Replicas(model, [torch.device("cpu")])
    replicas.by_device["other"] = copy  # a second device's replica, as a mesh across cards holds it
    replicas.sync()
    with torch.no_grad():
        torch.testing.assert_close(copy.score_all(users), model.score_all(users), rtol=0, atol=0)
