"""Mixed precision (``compute_dtype: "bfloat16"``) in the port against the JAX
package: for one model of each batch kind, the bfloat16 loss and every
parameter's gradient against JAX ``_loss_with_dtype(model, "bfloat16")`` on
the same parameters and batch; the JAX ``tests/test_mixed_precision.py``
tests on the port (bfloat16 gradients track float32 ones, parameters stay
float32, MF dense and sparse learn, a bfloat16 SASRec epoch); a bfloat16
SASRec's ``test()`` against the JAX bfloat16 model's; one bfloat16 step on
(4, 1) and (2, 2) meshes against JAX's; and every shipped config training an
epoch in bfloat16."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
import test_torch_graph_models as graph_tests
import test_torch_grocery_models as grocery_tests
import test_torch_mf as mf_tests
import test_torch_multineg_models as multineg_tests
import test_torch_ncf_models as ncf_tests
import test_torch_seq_models as seq_tests
import test_torch_train_sasrec as sasrec_tests
from test_torch_mesh_dense import jax_mesh, port_mesh
from test_torch_train_mf import _models as mf_models
from test_torch_train_mf import jax_epoch_batches, structured_split

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.train_engine import _loss_with_dtype as jax_loss_with_dtype
from beta_recsys_tpu.core.train_engine import make_epoch_fn as jax_make_epoch_fn
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.data.sequential_data import SequentialData as JaxSequentialData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.recommenders import SASRec as JaxSASRecRecommender
from beta_recsys_tpu_torch import recommenders as rec
from beta_recsys_tpu_torch.config import Config, load_config
from beta_recsys_tpu_torch.convert import flatten_params, mf_params_from_jax, ncf_params_from_jax
from beta_recsys_tpu_torch.core.checkpoint import load_metadata
from beta_recsys_tpu_torch.core.mixed_precision import loss_with_dtype
from beta_recsys_tpu_torch.core.train_engine import (
    SequenceEpochTrainer,
    TrainEngine,
    make_epoch_fn,
    make_negative_sampler,
    make_optimizer,
)
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.data.sequential_data import SequentialData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.datasets.synthetic import add_synthetic_baskets
from beta_recsys_tpu_torch.models import mixgcf
from beta_recsys_tpu_torch.models import vaecf as port_vaecf
from beta_recsys_tpu_torch.models.mf import MF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "parity_runs/checkpoints/SASRec_default_20260821_081415_yybcvt")
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
THRESHOLD = 0.32  # the JAX test's bar: random ~0.20 over 21 candidates
# bfloat16 against bfloat16: XLA on the CPU fuses elementwise ops and rounds
# once where torch rounds each op, so the two agree to bfloat16's few bits.
LOSS_RTOL = 2e-2
TEST_USERS = 240  # the bfloat16 SASRec test()'s users
GRAD_REL, GRAD_FLOOR = 0.1, 1e-2  # the JAX test's rule: |g - want| < 0.1 * max(|want|, 1e-2)


def _grads_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = GRAD_REL * np.maximum(np.abs(want), GRAD_FLOOR)
    worst = np.max(np.abs(got - want) - bound) if got.size else 0.0
    assert worst <= 0, (what, float(np.max(np.abs(got - want) / np.maximum(np.abs(want), GRAD_FLOOR))))


def check_bf16(ref, params, ours, batch, rng_key=None, generator=None, convert=flatten_params):
    """The port's bfloat16 loss and gradients against JAX's on ``batch``."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want_loss, want_grads = jax.value_and_grad(jax_loss_with_dtype(ref, "bfloat16"))(jparams, jbatch, rng_key)
    tbatch = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32 if np.asarray(v).dtype.kind == "f"
                                 else torch.long) for k, v in batch.items()}
    ours.zero_grad(set_to_none=True)
    loss = loss_with_dtype(ours, "bfloat16")(tbatch, generator)
    loss.backward()
    assert loss.dtype == torch.float32 and want_loss.dtype == jnp.float32
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    want = convert(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(want) == {name for name, _ in ours.named_parameters()}
    for name, p in ours.named_parameters():
        assert p.dtype == torch.float32, name
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        assert grad.dtype == torch.float32, name
        _grads_close(grad.numpy(), np.asarray(want[name]), name)


@pytest.fixture(scope="module")
def split():
    return structured_split()


@pytest.fixture(scope="module")
def data(split):
    return BaseData(split)


# -- one model of each batch kind against JAX ------------------------------------------


def test_mf_pairwise(data):
    ref, ours, params = mf_tests._pair()
    check_bf16(ref, params, ours, mf_tests._batch(), convert=mf_params_from_jax)


def test_ncf_pointwise():
    ref, params, ours = ncf_tests._pair("NCF")
    check_bf16(ref, params, ours, ncf_tests._batch(n=40), convert=ncf_params_from_jax)


def test_mixgcf_multineg(data, monkeypatch):
    cfg = dict(multineg_tests.MIX, pool="mean", edge_dropout_rate=0.0, mess_dropout_rate=0.0)
    ref, params, ours = multineg_tests._models(data, cfg)
    seeds = np.random.default_rng(2).uniform(size=(48, 1, ref.n_hops + 1, 1)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(seeds))
    monkeypatch.setattr(mixgcf, "mixing_seeds", lambda gen, shape, device: torch.as_tensor(seeds))
    check_bf16(ref, params, ours, multineg_tests._batch(data, ref.num_neg), jax.random.key(0))


@pytest.mark.parametrize("fmt", ["dense", "chunked"])
def test_lightgcn_pairwise_through_both_propagators(data, fmt):
    ref, params, ours = graph_tests._models(data, "LightGCN-3", fmt)
    check_bf16(ref, params, ours, graph_tests._batch(data))


def test_sasrec_sequence(split):
    """Both sides through the flash kernels' numerics (float32 inside): the
    Pallas kernel in interpret mode, the port's plain version."""
    seq_data = SequentialData(split)
    _, ref, params, ours = sasrec_tests._models(seq_data, fused_attention=True)
    check_bf16(ref, params, ours, sasrec_tests._batch(seq_data))


def test_tisasrec_sequence_time():
    ref, params, ours = seq_tests._tisasrec()
    check_bf16(ref, params, ours, seq_tests._tisasrec_batch())


def test_narm_prefix():
    ref, params, ours = seq_tests._narm()
    check_bf16(ref, params, ours, seq_tests._narm_batch(), jax.random.key(3), torch.Generator().manual_seed(0))


def test_vaecf_userrow_with_the_same_noise(monkeypatch):
    ref, params, ours = seq_tests._vaecf()
    users = np.array([0, 3, 5, 7, 11])
    batch = {"rows": seq_tests._user_rows()[users], "users": users.astype(np.int32)}
    key = jax.random.key(5)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (len(users), 4))))
    monkeypatch.setattr(port_vaecf, "latent_noise", lambda generator, shape, device: eps)
    check_bf16(ref, params, ours, batch, key, torch.Generator().manual_seed(0))


def test_triple2vec_triple():
    _, ref, params, ours = grocery_tests._pair("Triple2vec", 0)
    check_bf16(ref, params, ours, grocery_tests._batch(0), jax.random.key(0))


# -- the JAX package's tests/test_mixed_precision.py on the port -------------------


def _mf(data):
    cfg = {"model": "MF", "emb_dim": 16, "loss": "bpr", "optimizer": "adam", "lr": 0.05, "reg": 0.0,
           "batch_size": 128}
    return cfg, MF(cfg, data.n_users, data.n_items, device="cpu").init_weights(torch.Generator().manual_seed(0))


def test_bf16_grads_close_to_fp32(data):
    """The bfloat16 loss gradient tracks the float32 one, in float32."""
    _, model = _mf(data)
    n = torch.arange(32)
    batch = {"users": n % data.n_users, "pos_items": n % data.n_items, "neg_items": (n * 7 + 3) % data.n_items}
    grads = []
    for dtype in (None, "bfloat16"):
        model.zero_grad(set_to_none=True)
        loss_with_dtype(model, dtype)(batch).backward()
        grads.append({name: p.grad.clone() for name, p in model.named_parameters()})
    for name, g32 in grads[0].items():
        assert grads[1][name].dtype == g32.dtype == torch.float32, name
        _grads_close(grads[1][name].numpy(), g32.numpy(), name)


def test_bf16_epoch_keeps_fp32_params(data):
    cfg, model = _mf(data)
    trainer = make_epoch_fn(model, make_optimizer(cfg, model.parameters()), data.train_arrays(), cfg["batch_size"],
                            make_negative_sampler(data, "bitmask", device="cpu"), compute_dtype="bfloat16")
    loss = trainer.run(torch.Generator().manual_seed(2))
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
    for state in trainer.optimizer.state.values():
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32


def _engine_config(tmp_path, **model):
    return Config({
        "system": {"root_dir": str(tmp_path), "metrics": ["ndcg"], "k": [10], "valid_metric": "ndcg", "valid_k": 10,
                   "seed": 11},
        "dataset": {"dataset": "synthetic"},
        "model": {"model": "MF", "loss": "bpr", "emb_dim": 16, "batch_size": 128, "optimizer": "adam", "lr": 0.05,
                  "max_epoch": 30, "max_n_update": 30, "compute_dtype": "bfloat16", **model},
    })


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_mf_learns_in_bf16(data, tmp_path, sparse):
    """An engine run in bfloat16, dense and through lazy Adam, reaches the
    JAX test's quality bar; parameters and moments stay float32."""
    cfg = _engine_config(tmp_path, sparse_optim=sparse)
    model = MF(cfg.model, data.n_users, data.n_items, device="cpu")
    engine = TrainEngine(cfg, "cpu").build(model, data, data.eval_candidates(data.valid[0]), None)
    result = engine.train(verbose=False)
    assert result["valid_metric"] > THRESHOLD, result
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if sparse:
        assert all(m.dtype == v.dtype == torch.float32 for m, v in engine.epoch_fn.state["moments"].values())


def test_sasrec_bf16_epoch(data):
    seq_data = SequentialData((data.train, [], []), intersect=False)
    cfg = {"model": "SASRec", "emb_dim": 16, "maxlen": 8, "num_blocks": 1, "num_heads": 1, "dropout_rate": 0.0,
           "l2_emb": 0.0, "batch_size": 16, "optimizer": "adam", "lr": 0.001}
    model = rec.SASRec(cfg, device="cpu")._build_model(seq_data.n_users, seq_data.n_items)
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = SequenceEpochTrainer(model, make_optimizer(cfg, model.parameters()), seq_data.train_seq_arrays(8), 16,
                                   make_negative_sampler(seq_data, "bitmask", device="cpu"), compute_dtype="bfloat16")
    assert torch.isfinite(trainer.run(torch.Generator().manual_seed(3)))


# -- the model-level cast: a bfloat16 SASRec serves as JAX's does -----------------------


def test_bf16_sasrec_test_metrics_match_jax(tmp_path):
    """The JAX-trained checkpoint served with the model's compute_dtype
    bfloat16 (features in bfloat16, scores promoted to float32 against the
    float32 item table) by both packages, test() over the test candidates
    of the first TEST_USERS users (JAX's Pallas kernel interprets slowly)."""
    train, valid, (test,) = load_split_data(SPLIT, n_test=1)
    keep = test["col_user"] < TEST_USERS
    test = {col: values[keep] for col, values in test.items()}
    cfg = load_config(CHECKPOINT).replace(system={"root_dir": str(tmp_path / "port")},
                                          model={"compute_dtype": "bfloat16"})
    ours = rec.SASRec(cfg, device="cpu").load(CHECKPOINT, SequentialData((train, valid, [test])))
    raw = load_metadata(CHECKPOINT)["config"]
    raw["system"]["root_dir"] = str(tmp_path / "jax")
    raw["model"]["compute_dtype"] = "bfloat16"
    # The flash kernel's numerics on both sides (float32 inside, bfloat16
    # out): the Pallas kernel in interpret mode, the TPU's serving path. The
    # JAX einsum route rounds scores and probabilities to bfloat16 instead.
    raw["model"]["fused_attention"] = True
    jax_train, jax_valid, (jax_test,) = jax_load_split_data(SPLIT, n_test=1)
    jax_test = jax_test[jax_test["col_user"] < TEST_USERS]
    ref = JaxSASRecRecommender(JaxConfig(raw)).load(CHECKPOINT,
                                                    JaxSequentialData((jax_train, jax_valid, [jax_test])))
    users = torch.arange(8)
    with torch.no_grad():
        feats = ours.test_model()._final_feats(users)
        scores = ours.test_model().score_all(users)
    assert feats.dtype == torch.bfloat16 and scores.dtype == torch.float32
    got, want = ours.test(), ref.test()
    assert list(got) == list(want)
    for key in want:
        if "@" in key:  # bfloat16 features rounded in other orders: one user's rank swap at most
            assert abs(got[key] - want[key]) <= 1.0 / TEST_USERS + 1e-6, (key, got[key], want[key])


# -- one bfloat16 step on a mesh ------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_bf16_mesh_step_matches_jax(split, monkeypatch, mesh_shape):
    """MF's one step over the whole train set on a data axis (each shard's
    bfloat16 loss, one all-reduce) and on a model axis (the tables
    row-sharded, gathered in float32, cast after): the loss and Adam's first
    moment (0.1 of the gradient) against JAX's on the same mesh shape."""
    from beta_recsys_tpu_torch.parallel import sharding

    monkeypatch.setattr(sharding, "MIN_SHARDED_ROWS", 1)
    train, valid, test = split
    data = BaseData(split)
    jax_data = JaxBaseData((pd.DataFrame(train), [pd.DataFrame(f) for f in valid], [pd.DataFrame(f) for f in test]))
    cfg, ref, params, ours = mf_models(data)
    n = len(data.train_arrays().users)
    rng, opt = jax.random.key(3), optax.adam(cfg["lr"])
    jax_epoch = jax_make_epoch_fn(ref, opt, jax_data.train_arrays(), n, jax_make_negative_sampler(jax_data),
                                  donate=False, mesh=jax_mesh(mesh_shape), compute_dtype="bfloat16")
    _, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)
    trainer = make_epoch_fn(ours, make_optimizer(cfg, ours.parameters()), data.train_arrays(), n,
                            make_negative_sampler(data, device="cpu"), mesh=port_mesh(mesh_shape),
                            compute_dtype="bfloat16")
    assert trainer.num_batches == int(want_state[0].count) == 1
    loss = trainer.run_batches(*jax_epoch_batches(rng, jax_data, n))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    mu = mf_params_from_jax(jax.tree_util.tree_map(np.asarray, want_state[0].mu))
    states = trainer.dp.named_states()
    for name, p in ours.named_parameters():
        assert p.dtype == torch.float32
        _grads_close(states[name]["exp_avg"].numpy() / 0.1, mu[name].numpy() / 0.1, name)


# -- every shipped config trains an epoch in bfloat16 ---------------------------------

SHIPPED = {
    "mf": (rec.MatrixFactorization, "mf"), "gmf": (rec.GMFRecommender, "gmf"), "mlp": (rec.MLPRecommender, "mlp"),
    "ncf": (rec.NeuCF, "ncf"), "pairwise_gmf": (rec.PairwiseGMFRecommender, "pairwise_gmf"),
    "lightgcn": (rec.LightGCN, "lightgcn"), "ngcf": (rec.NGCF, "ngcf"), "ultragcn": (rec.UltraGCN, "ultragcn"),
    "sgl": (rec.SGL, "sgl"), "simgcl": (rec.SimGCL, "simgcl"), "mixgcf": (rec.MixGCF, "mixgcf"),
    "buir": (rec.BUIR, "buir"), "lcfn": (rec.LCFN, "lcfn"), "vaecf": (rec.VAECF, "vaecf"), "cmn": (rec.CMN, "cmn"),
    "sasrec": (rec.SASRec, "sasrec"), "tisasrec": (rec.TiSASRec, "tisasrec"), "narm": (rec.NARM, "narm"),
    "triple2vec": (rec.Triple2vec, "triple2vec"), "vbcar": (rec.VBCAR, "vbcar"), "tvbr": (rec.TVBR, "tvbr"),
}


@pytest.mark.parametrize("name", list(SHIPPED))
def test_every_shipped_config_trains_an_epoch_in_bf16(split, tmp_path, name):
    """At a narrow width, short sequences and large batches: a finite
    loss, float32 parameters after the step and a valid metric (the torch
    matmuls raise on the mixed types that JAX promotes, so each promotion
    site is exercised)."""
    cls, config = SHIPPED[name]
    cfg = load_config(os.path.join(REPO, "configs", f"{config}_default.json")).replace(
        system={"root_dir": str(tmp_path), "seed": 0},
        model={"max_epoch": 1, "compute_dtype": "bfloat16", "emb_dim": 8, "batch_size": 512, "n_sample": 300,
               "maxlen": 10})
    train, valid, test = split
    if cls.data_class.__name__ == "GroceryData":
        train = add_synthetic_baskets(train)
    recommender = cls(cfg, device="cpu")
    result = recommender.train(cls.data_class((train, valid, test)))
    assert np.isfinite(result["valid_metric"])
    assert all(p.dtype == torch.float32 for p in recommender.model.parameters())


def test_row_sharded_lazy_adam_in_bf16_matches_one_device(data, tmp_path):
    """The row-sharded lazy-Adam trainer on a (1, 2) mesh gathers float32
    rows, casts them in the loss and updates float32 shards: one epoch
    equals the one-device lazy-Adam trainer's in bfloat16."""
    trained = []
    for mesh in (None, {"data": 1, "model": 2}):
        cfg = _engine_config(tmp_path, sparse_optim=True, max_epoch=1).replace(system={"mesh": mesh})
        model = MF(cfg.model, data.n_users, data.n_items, device="cpu")
        engine = TrainEngine(cfg, "cpu", mesh_devices=["cpu"] * 2 if mesh else None)
        engine.build(model, data, data.eval_candidates(data.valid[0]), None)
        assert type(engine.epoch_fn).__name__ == ("ShardedSparseEpochTrainer" if mesh else "SparseEpochTrainer")
        engine.train(verbose=False)
        engine._restore_live()
        trained.append({name: p.detach().clone() for name, p in model.named_parameters()})
    for name, want in trained[0].items():
        assert trained[1][name].dtype == torch.float32
        torch.testing.assert_close(trained[1][name], want, rtol=0, atol=1e-6, msg=name)
