"""The dense trainers on a device mesh against the JAX package: one epoch of
MF (pairwise), BUIR (``post_update``), NCF (pointwise), UltraGCN
(multineg), SGL and LightGCN on the batches the JAX epoch forms, on (4, 1)
and (2, 2) meshes, against the JAX ``make_epoch_fn`` on the same mesh shape
of the JAX tests' virtual CPU devices: the loss, every parameter and Adam's
moments. A (4, 1) mesh holds the JAX ``shard_map`` result (each data shard's
loss and gradient, then one pmean), a (2, 2) mesh the partitioner's (the
whole batch's loss) with every table row-sharded over "model" and gathered
by the ring all-gather. The port's meshes repeat the CPU device. Also
``make_sharded_train_step`` against the JAX one, and the placement helpers."""

import jax
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from test_torch_multineg_models import ULTRA, ultragcn_artifacts
from test_torch_ssl_models import CONFIGS, inject_sgl_draws
from test_torch_train_mf import _models as mf_models
from test_torch_train_mf import jax_epoch_batches, structured_split
from test_torch_train_multineg import jax_multineg_batches
from test_torch_train_pointwise import jax_pointwise_batches

from beta_recsys_tpu.core.train_engine import make_epoch_fn as jax_make_epoch_fn
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.models import MODEL_REGISTRY as JAX_MODELS
from beta_recsys_tpu.parallel.sharding import default_param_rule as jax_default_param_rule
from beta_recsys_tpu.parallel.sharding import make_sharded_train_step as jax_make_sharded_train_step
from beta_recsys_tpu.parallel.sharding import shard_batch as jax_shard_batch
from beta_recsys_tpu.parallel.sharding import shard_params as jax_shard_params
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.core.train_engine import make_epoch_fn, make_negative_sampler, make_optimizer
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.models import build_model
from beta_recsys_tpu_torch.parallel import (
    REPLICATED,
    ROW_SHARDED,
    default_param_rule,
    make_mesh,
    make_sharded_train_step,
    pad_to_multiple,
    shard_batch,
    shard_params,
)
from beta_recsys_tpu_torch.parallel import sharding
from beta_recsys_tpu_torch.parallel.collectives import recording
from beta_recsys_tpu_torch.parallel.data_parallel import mesh_round_batch

# JAX's own tests/test_mesh_epoch.py bound: the shards' sums and the pmean
# add in other orders than one device's, and Adam compounds it over steps.
RTOL, ATOL = 2e-5, 1e-5
MESHES = [(4, 1), (2, 2)]
BATCH, LR, NUM_NEG = 126, 0.01, 4  # 126 rounds to 124 on a data axis of 4, stays on 2


def jax_mesh(shape):
    n_data, n_model = shape
    return JaxMesh(np.array(jax.devices()[: n_data * n_model]).reshape(n_data, n_model), ("data", "model"))


def port_mesh(shape):
    return make_mesh(shape[0], shape[1], ["cpu"] * (shape[0] * shape[1]))


@pytest.fixture
def every_table(monkeypatch):
    """Every trained (n_users | n_items, d) table row-sharded on a model
    axis, whatever its height (the JAX rule's 1,024 rows would leave these
    small tables whole)."""
    monkeypatch.setattr(sharding, "MIN_SHARDED_ROWS", 1)


def close(got, want, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def epoch_matches(trainer, ours, loss, want_params, want_state, want_loss):
    """The loss, every parameter and Adam's moments and count against the
    JAX epoch's; a parameter no gradient reaches keeps optax's zero moments."""
    trainer.dp.assemble()
    close(loss, want_loss, "loss")
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want_params))
    mu = flatten_params(jax.tree_util.tree_map(np.asarray, want_state[0].mu))
    nu = flatten_params(jax.tree_util.tree_map(np.asarray, want_state[0].nu))
    states = trainer.dp.named_states()
    for name, p in ours.named_parameters():
        close(p, want[name], name)
        state = states.get(name)
        if state is None:
            assert not mu[name].any() and not nu[name].any(), name
            continue
        close(state["exp_avg"], mu[name], f"mu {name}")
        close(state["exp_avg_sq"], nu[name], f"nu {name}")
        assert int(state["step"]) == int(want_state[0].count) == trainer.num_batches


@pytest.fixture(scope="module")
def both():
    split = structured_split()
    train, valid, test = split
    return BaseData(split), JaxBaseData((pd.DataFrame(train), [pd.DataFrame(f) for f in valid],
                                         [pd.DataFrame(f) for f in test]))


PAIRWISE = {
    "MF": None,
    "BUIR": (CONFIGS["BUIR"], "sym"),
    "SGL": (CONFIGS["SGL"], "sym"),
    "LightGCN": ({"model": "LightGCN", "emb_dim": 16, "layer_size": [16, 16], "regs": [1e-3], "keep_pro": 1.0},
                 "row_selfloop"),
    "NCF": ({"model": "NCF", "emb_dim": 8, "mlp_config": {"n_layers": 2}, "dropout": 0.0, "stddev": 0.3,
             "num_negative": NUM_NEG, "loss": "bce"}, None),
    "UltraGCN": (dict(ULTRA, ii_neighbor_num=4, num_negative=6), None),
}


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", list(PAIRWISE))
def test_epoch_on_a_mesh_matches_jax(both, monkeypatch, every_table, name, mesh_shape):
    data, jax_data = both
    if name == "MF":  # well-conditioned: BPR's bias gradients at zero biases are rounding (test_torch_train_mf)
        cfg, ref, params, ours = mf_models(data)
    else:
        cfg, variant = PAIRWISE[name]
        cfg = dict(cfg, lr=LR, optimizer="adam")
        artifacts = ultragcn_artifacts(data, cfg["ii_neighbor_num"]) if name == "UltraGCN" else (
            {"adj": data.get_norm_adj(variant)} if variant else {})
        ref = JAX_MODELS[name](cfg, data.n_users, data.n_items, artifacts)
        params = ref.init_params(jax.random.key(0))
        ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
        ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    if name == "SGL":
        inject_sgl_draws(monkeypatch, data, ours, 2)
    kind = ours.batch_kind
    num_neg = int(getattr(ours, "num_neg", cfg.get("num_negative", 4)))

    rng, opt = jax.random.key(3), optax.adam(cfg["lr"])
    jax_epoch = jax_make_epoch_fn(ref, opt, jax_data.train_arrays(), BATCH, jax_make_negative_sampler(jax_data),
                                  num_neg=num_neg, donate=False, mesh=jax_mesh(mesh_shape))
    want_params, want_state, _, want_loss = jax_epoch(params, opt.init(params), rng)
    batch_size = mesh_round_batch(BATCH, port_mesh(mesh_shape))
    if kind == "pointwise":
        batches = jax_pointwise_batches(rng, jax_data, batch_size, num_neg)
    elif kind == "multineg":
        batches = jax_multineg_batches(rng, jax_data, batch_size, num_neg)
    else:
        batches = jax_epoch_batches(rng, jax_data, batch_size)

    optimizer = make_optimizer(cfg, [p for p in ours.parameters() if p.requires_grad])
    trainer = make_epoch_fn(ours, optimizer, data.train_arrays(), BATCH, make_negative_sampler(data, device="cpu"),
                            num_neg, mesh=port_mesh(mesh_shape))
    assert trainer.batch_size == batch_size == (124 if mesh_shape[0] == 4 else 126)
    assert trainer.num_batches == batches[0].shape[0] == int(want_state[0].count)
    if mesh_shape[1] > 1:
        assert set(trainer.dp.tables) == {n for n, p in ours.named_parameters()
                                          if p.requires_grad and p.dim() == 2
                                          and p.shape[0] in (data.n_users, data.n_items)} != set()
    with recording() as counts:
        loss = trainer.run_batches(*batches, generator=torch.Generator())
    if mesh_shape[1] > 1:  # the whole batch's loss: the tables' ring gathers, no all-reduce
        assert counts.pop("all_gather")["calls"] == counts.pop("reduce_scatter")["calls"] \
            == len(trainer.dp.tables) * trainer.num_batches
    else:  # each data shard's loss, then one all-reduce a step
        assert counts.pop("all_reduce")["calls"] == trainer.num_batches
    assert not counts
    epoch_matches(trainer, ours, loss, want_params, want_state, want_loss)


def test_a_data_axis_computes_the_shards_mean_not_the_batch_loss(both, monkeypatch):
    """SGL's in-batch InfoNCE couples a batch's rows: on (4, 1) the step's
    loss is the mean of the four shards' losses, which differs from the
    whole batch's (the one-device loss), as in the JAX package."""
    data, _ = both
    cfg = dict(CONFIGS["SGL"], lr=LR, optimizer="adam")
    artifacts = {"adj": data.get_norm_adj("sym")}
    inject = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    inject.init_weights(torch.Generator().manual_seed(0))
    inject_sgl_draws(monkeypatch, data, inject, 2)
    losses = []
    for mesh in (None, port_mesh((4, 1))):
        ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
        ours.load_state_dict(inject.state_dict())
        trainer = make_epoch_fn(ours, make_optimizer(cfg, ours.parameters()), data.train_arrays(), 124,
                                make_negative_sampler(data, device="cpu"), mesh=mesh)
        users, pos, neg = trainer.form(torch.Generator().manual_seed(0))
        losses.append(trainer.run_batches(users[:1], pos[:1], neg[:1]))
    assert abs(float(losses[0]) - float(losses[1])) > 1e-4


def _mf_problem(n_users=32, n_items=64, emb=16):
    cfg = {"model": "MF", "emb_dim": emb, "loss": "bpr", "lr": 0.1}
    ref = JAX_MODELS["MF"](cfg, n_users, n_items)
    params = ref.init_params(jax.random.key(0))
    ours = build_model(cfg, n_users, n_items, {}, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(0)
    batch = {"users": rng.integers(0, n_users, 16).astype(np.int32),
             "pos_items": rng.integers(0, n_items, 16).astype(np.int32),
             "neg_items": rng.integers(0, n_items, 16).astype(np.int32)}
    return ref, params, ours, batch


def test_sharded_step_matches_the_jax_one():
    """``make_sharded_train_step`` on a (4, 2) mesh, every table
    row-sharded, one sgd step against the JAX package's on its (4, 2) mesh
    (the counterpart of tests/test_sharding.py's)."""
    ref, params, ours, batch = _mf_problem()
    rule = jax_default_param_rule(ref.n_users, ref.n_items, min_rows=1)
    mesh = jax_mesh((4, 2))
    jax_step, _ = jax_make_sharded_train_step(ref, optax.sgd(0.1), mesh, param_rule=rule)
    s_params = jax_shard_params(params, mesh, rule)
    want_params, _, want_loss = jax_step(s_params, optax.sgd(0.1).init(s_params), jax_shard_batch(batch, mesh),
                                         jax.random.key(1))

    step, place = make_sharded_train_step(ours, torch.optim.SGD(ours.parameters(), lr=0.1), port_mesh((4, 2)),
                                          param_rule=default_param_rule(ours.n_users, ours.n_items, min_rows=1))
    assert set(step.tables) == {"user_emb", "item_emb"} and step.mode == "model"
    loss = step({k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()})
    step.assemble()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want_params))
    for name, p in ours.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    with torch.no_grad():
        ours.user_emb.zero_()
    place()
    assert not any(s.any() for s in step.tables["user_emb"])


def test_placement_rules_and_helpers():
    """``default_param_rule`` as the JAX rule decides; ``shard_params``,
    ``shard_batch`` and ``pad_to_multiple`` hold what the JAX placement
    holds on each device."""
    torch_rule, jax_rule = default_param_rule(40, 60), jax_default_param_rule(40, 60)
    for shape in ((40, 8), (60, 8), (61, 8), (40,), (8, 40)):
        want = jax_rule(np.zeros(shape))
        assert torch_rule(torch.zeros(shape)) == (ROW_SHARDED if want == jax.sharding.PartitionSpec("model", None)
                                                  else REPLICATED)
    assert default_param_rule(2000, 60)(torch.zeros(2000, 8)) == ROW_SHARDED
    mesh, jm = port_mesh((2, 2)), jax_mesh((2, 2))
    rng = np.random.default_rng(0)
    params = {"user_emb": rng.normal(size=(6, 4)).astype(np.float32), "w": rng.normal(size=(3,)).astype(np.float32)}
    rule = default_param_rule(6, 9, min_rows=1)
    placed = shard_params({k: torch.from_numpy(v) for k, v in params.items()}, mesh, rule)
    want = jax_shard_params(params, jm, jax_default_param_rule(6, 9, min_rows=1))
    for name, shards in placed.items():
        by_index = {s.device.id: np.asarray(s.data) for s in want[name].addressable_shards}
        for d in range(2):
            for m in range(2):
                np.testing.assert_array_equal(shards[d][m].numpy(), by_index[jm.devices[d][m].id], err_msg=name)
    batch = {"users": np.arange(8)}
    placed = shard_batch({"users": torch.arange(8)}, mesh)
    want = jax_shard_batch(batch, jm)
    by_index = {s.device.id: np.asarray(s.data) for s in want["users"].addressable_shards}
    for d in range(2):
        for m in range(2):
            np.testing.assert_array_equal(placed["users"][d][m].numpy(), by_index[jm.devices[d][m].id])
    np.testing.assert_array_equal(pad_to_multiple(np.arange(5), 4), [0, 1, 2, 3, 4, 0, 1, 2])
