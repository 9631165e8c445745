"""The lazy-Adam trainer's packed row layouts ("unified", "compact",
"unified_bf16") against the JAX package's ``make_sparse_epoch_fn`` with the
same ``row_update`` on the same batches: two epochs through ``run_batches``
give JAX's parameters, moments, step, loss and dropped count. Also: the
compact capacity estimate, a compact capacity of 16 dropping JAX's count, the
bfloat16 packing round trip, bfloat16 compute under a layout, the packed
write's plain version (its masks, ids outside every table, its checks and C
layout), the engine training each layout into a checkpoint the JAX package
loads, and the dropped warning after every epoch that dropped rows."""

import ctypes
import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.core.sparse_optim import init_sparse_state as jax_init_sparse_state
from beta_recsys_tpu.core.sparse_optim import make_sparse_epoch_fn as jax_make_sparse_epoch_fn
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.recommenders import MatrixFactorization as JaxMatrixFactorization
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.core.checkpoint import load_raw_checkpoint
from beta_recsys_tpu_torch.core.sparse_optim import PackedRows, SparseEpochTrainer, compact_capacity_estimate
from beta_recsys_tpu_torch.core.train_engine import TrainEngine, make_negative_sampler, make_optimizer
from beta_recsys_tpu_torch.models import build_model
from beta_recsys_tpu_torch.ops.kernels import rowadam
from beta_recsys_tpu_torch.ops.kernels.rowadam import (
    RowAdamPacked,
    bias_denominators,
    fused_rowadam_packed,
    fused_rowadam_packed_bf16,
    packed_touched,
    repack16,
    unpack16_components,
)
from beta_recsys_tpu_torch.recommenders import MatrixFactorization
from tests.test_torch_mixed_precision import GRAD_FLOOR, GRAD_REL, LOSS_RTOL
from tests.test_torch_train_mf import (  # noqa: F401 (split: the fixture)
    BATCH,
    LR,
    _both_data,
    _close,
    _config,
    _models,
    jax_epoch_batches,
    split,
)

# "unified_bf16" on both sides rounds its moments to bfloat16; where the two
# float32 computations before that rounding part by an ulp, a moment lands on
# the other bfloat16 neighbour: one bfloat16 ulp (2^-8 relative). That moves
# a parameter by at most ~lr * 2^-8 = 2e-4 at lr 0.05.
BF16_PARAM_RTOL, BF16_PARAM_ATOL = 1e-3, 5e-4


def _jax_run(ref, jax_data, params, row_update, **kw):
    opt = optax.adam(LR)
    fn = jax_make_sparse_epoch_fn(ref, jax_data.train_arrays(), BATCH, jax_make_negative_sampler(jax_data), LR,
                                  dense_optimizer=opt, donate=False, row_update=row_update, **kw)
    state = (jax_init_sparse_state(params, list(ref.row_tables())), opt.init({"global_bias": params["global_bias"]}))
    return fn, state


def _trainer(data, cfg, ours, row_update, **kw):
    tables = ours.row_tables()
    dense = [p for name, p in ours.named_parameters() if name not in tables]
    return SparseEpochTrainer(ours, data.train_arrays(), BATCH, make_negative_sampler(data, device="cpu"), LR,
                              make_optimizer(cfg, dense), row_update=row_update, **kw)


def bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits); 0 at 0."""
    mant, exp = np.frexp(np.abs(np.asarray(x, np.float32)))
    return np.where(mant == 0, 0.0, np.ldexp(1.0, exp - 8))


@pytest.mark.parametrize("row_update", ["unified", "compact", "unified_bf16"])
def test_layout_epochs_match_jax(split, row_update):
    data, jax_data = _both_data(split)
    cfg, ref, params, ours = _models(data)
    fn, jax_state = _jax_run(ref, jax_data, params, row_update)
    trainer = _trainer(data, cfg, ours, row_update)
    rng = jax.random.key(5)
    for epoch in (1, 2):
        batches = jax_epoch_batches(rng, jax_data, BATCH)
        params, jax_state, rng, want_loss = fn(params, jax_state, rng)
        _close(trainer.run_batches(*batches), want_loss)
        assert trainer.state["step"] == int(jax_state[0]["step"]) == epoch * trainer.num_batches
        assert int(trainer.state["dropped"]) == int(jax_state[0]["dropped"]) == 0
        for name, p in ours.named_parameters():
            if row_update == "unified_bf16":
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[name]), rtol=BF16_PARAM_RTOL,
                                           atol=BF16_PARAM_ATOL, err_msg=name)
            else:
                _close(p, params[name])
        for name, pair in trainer.state["moments"].items():
            for got, want in zip(pair, jax_state[0]["moments"][name]):
                if row_update == "unified_bf16" and got.dim() == 2:
                    got, want = got.numpy(), np.asarray(want)
                    assert np.all(np.abs(got - want) <= np.maximum(bf16_ulp(got), bf16_ulp(want))), name
                    assert np.array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())  # bfloat16 values
                else:
                    _close(got, want)
    # Between epochs the trainer holds nothing packed: the model and state are the tables.
    assert trainer._packed is None


def _jax_compact_capacity(fn):
    """The capacity a JAX "compact" epoch function closed over."""
    inner = fn.__wrapped__
    return dict(zip(inner.__code__.co_freevars, (c.cell_contents for c in inner.__closure__)))["compact_capacity"]


@pytest.mark.parametrize("batch_size", [7, 64, 256])
def test_compact_capacity_estimate_equals_jax(split, batch_size):
    data, jax_data = _both_data(split)
    _, ref, params, _ = _models(data)
    fn = jax_make_sparse_epoch_fn(ref, jax_data.train_arrays(), batch_size, jax_make_negative_sampler(jax_data), LR,
                                  donate=False, row_update="compact")
    arrays = data.train_arrays()
    assert compact_capacity_estimate(arrays.users, arrays.items, batch_size) == _jax_compact_capacity(fn)


def test_trainer_takes_the_estimate_or_the_given_capacity(split):
    data, jax_data = _both_data(split)
    cfg, ref, params, ours = _models(data)
    fn, _ = _jax_run(ref, jax_data, params, "compact")
    assert _trainer(data, cfg, ours, "compact").compact_capacity == _jax_compact_capacity(fn)
    assert _trainer(data, cfg, ours, "compact", compact_capacity=16).compact_capacity == 16
    assert _trainer(data, cfg, ours, "unified").compact_capacity is None


def test_compact_capacity_16_drops_jax_count(split):
    data, jax_data = _both_data(split)
    cfg, ref, params, ours = _models(data)
    fn, jax_state = _jax_run(ref, jax_data, params, "compact", compact_capacity=16)
    trainer = _trainer(data, cfg, ours, "compact", compact_capacity=16)
    rng = jax.random.key(7)
    for _ in (1, 2):
        batches = jax_epoch_batches(rng, jax_data, BATCH)
        params, jax_state, rng, want_loss = fn(params, jax_state, rng)
        _close(trainer.run_batches(*batches), want_loss)
        assert int(trainer.state["dropped"]) == int(jax_state[0]["dropped"]) > 0
        for name, p in ours.named_parameters():
            _close(p, params[name])
        for name, pair in trainer.state["moments"].items():
            for got, want in zip(pair, jax_state[0]["moments"][name]):
                _close(got, want)


def test_pack16_round_trips_float32_parameters_bit_for_bit():
    """Parameters through the int16 [p_hi|p_lo|m|v] rows and back keep every
    bit (signed zeros, subnormals, infinities, the largest finite); the
    moments come back as XLA's round-to-nearest-even bfloat16 of them."""
    rng = np.random.default_rng(0)
    p = (rng.standard_normal((50, 7)) * 10.0 ** rng.integers(-44, 38, (50, 7))).astype(np.float32)
    p[0, :5] = [-0.0, np.float32(1e-45), np.inf, -np.inf, np.finfo(np.float32).max]
    m = (rng.standard_normal((50, 7)) * 1e-3).astype(np.float32)
    v = np.abs(rng.standard_normal((50, 7)) * 1e-5).astype(np.float32)
    rows16 = repack16(*(torch.from_numpy(x) for x in (p, m, v)))
    assert rows16.dtype == torch.int16 and rows16.shape == (50, 28)
    got_p, got_m, got_v = unpack16_components(rows16, 7)
    assert np.array_equal(got_p.numpy().view(np.uint32), p.view(np.uint32))
    bits = rows16.numpy().view(np.uint16)
    assert np.array_equal((bits[:, :7].astype(np.uint32) << 16) | bits[:, 7:14], p.view(np.uint32))
    for got, x, cols in ((got_m, m, slice(14, 21)), (got_v, v, slice(21, 28))):
        want = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(x).astype(jnp.bfloat16), jnp.uint16))
        assert np.array_equal(bits[:, cols], want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)))
    # A whole layout: pack16 then unpack16 gives the tables back exactly.
    layout = PackedRows({"users": [("a", 7, 2)], "items": [("b", 3, 2), ("c", 4, 2)]}, {"users": 50, "items": 20})
    tables = {"a": torch.from_numpy(p), "b": torch.randn(20, 3), "c": torch.randn(20, 4)}
    moments = {k: (0.01 * torch.randn_like(t), torch.rand_like(t)) for k, t in tables.items()}
    packed = layout.pack16(tables, moments)
    assert packed.shape == (70, 28)
    out = {k: torch.empty_like(t) for k, t in tables.items()}
    out_m = {k: (torch.empty_like(t), torch.empty_like(t)) for k, t in tables.items()}
    layout.unpack16(packed, out, out_m)
    for k, t in tables.items():
        assert torch.equal(out[k].view(torch.int32), t.view(torch.int32))
        for got, want in zip(out_m[k], moments[k]):
            assert torch.equal(got, want.bfloat16().float())


@pytest.mark.parametrize("row_update", ["unified", "unified_bf16"])
def test_bfloat16_compute_under_a_layout_matches_jax(split, row_update):
    """One step over the whole train set as one batch: the loss, and the
    first moments (0.1 x the deduplicated gradient), against JAX's under
    the bfloat16 rule of tests/test_torch_mixed_precision.py; parameters and
    moments stay float32. (Later steps are not compared: Adam's first moves
    are +-lr wherever a gradient's sign rests on bfloat16 rounding.)"""
    data, jax_data = _both_data(split)
    cfg, ref, params, ours = _models(data)
    n = len(data.train_arrays().users)
    opt = optax.adam(LR)
    fn = jax_make_sparse_epoch_fn(ref, jax_data.train_arrays(), n, jax_make_negative_sampler(jax_data), LR,
                                  dense_optimizer=opt, donate=False, row_update=row_update, compute_dtype="bfloat16")
    jax_state = (jax_init_sparse_state(params, list(ref.row_tables())),
                 opt.init({"global_bias": params["global_bias"]}))
    tables = ours.row_tables()
    dense = [p for name, p in ours.named_parameters() if name not in tables]
    trainer = SparseEpochTrainer(ours, data.train_arrays(), n, None, LR, make_optimizer(cfg, dense),
                                 row_update=row_update, compute_dtype="bfloat16")
    rng = jax.random.key(9)
    batches = jax_epoch_batches(rng, jax_data, n)
    _, jax_state, _, want_loss = fn(params, jax_state, rng)
    loss = trainer.run_batches(*batches)
    assert trainer.state["step"] == 1 and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for name, (m, v) in trainer.state["moments"].items():
        assert m.dtype == v.dtype == ours.get_parameter(name).dtype == torch.float32
        want = np.asarray(jax_state[0]["moments"][name][0], np.float64)
        bound = GRAD_REL * np.maximum(np.abs(want), 0.1 * GRAD_FLOOR)  # m = 0.1 g
        assert np.all(np.abs(m.numpy() - want) <= bound), name


# -- the packed write's plain version ---------------------------------------------


def _packed_case(seed, w=6, total_rows=30):
    gen = torch.Generator().manual_seed(seed)
    packed = torch.randn(total_rows, 3 * w, generator=gen)
    packed[:, 2 * w:] = packed[:, 2 * w:].abs()
    ids = torch.randint(0, total_rows, (40,), generator=gen)
    grads = torch.randn(40, w, generator=gen)
    grads[::5] = 0.0
    from beta_recsys_tpu_torch.core.sparse_optim import _segment_dedup

    return (packed, *_segment_dedup(ids, grads))


def _touched_by_loop(tables, ids, grads):
    """Each row's columns of each table that holds its id, where that
    table's gradient columns are not all zero: the mask, one cell at a time."""
    mask = torch.zeros_like(grads)
    for r, i in enumerate(ids.tolist()):
        for row0, n, col0, width in tables:
            if row0 <= i < row0 + n and bool((grads[r, col0:col0 + width] != 0).any()):
                mask[r, col0:col0 + width] = 1.0
    return mask


@pytest.mark.parametrize("tables", [
    [(0, 12, 0, 5), (0, 12, 5, 1), (12, 18, 0, 5), (12, 18, 5, 1)],  # equal boundaries (MF's)
    [(0, 12, 0, 4), (0, 12, 4, 2), (12, 10, 0, 1), (12, 10, 1, 5), (22, 8, 0, 6)],  # a role indicator
], ids=["equal-boundaries", "role-indicator"])
def test_packed_masks_are_per_table(tables):
    """Roles of equal column boundaries (the JAX step's shortcut branch) and
    of differing ones (its role indicator) give each table's own touched
    columns; a row with an id outside every table gets none."""
    _, ids, grads = _packed_case(0)
    ids = ids.clone()
    ids[3] = 31  # outside every table
    grads[:, 5] = torch.where(torch.arange(grads.shape[0]) % 3 == 0, 0.0, grads[:, 5])  # a bias column at 0 alone
    assert torch.equal(packed_touched(tables, ids, grads), _touched_by_loop(tables, ids, grads))


def test_packed_plain_version_is_the_update_of_each_touched_table():
    """The float32 packed write against ``fused_rowadam_reference``'s
    arithmetic done cell by cell, JAX's order of operations: only a touched
    table's columns move; ids outside every table write nothing."""
    packed, ids, grads = _packed_case(1)
    tables = [(0, 12, 0, 5), (0, 12, 5, 1), (12, 18, 0, 5), (12, 18, 5, 1)]
    ids = ids.clone()
    ids[-1] = 100  # outside: its gradient row is never written anywhere
    denoms, lr, w = bias_denominators(4), 0.05, 6
    want = packed.clone()
    mask = _touched_by_loop(tables, ids, grads)
    for r, i in enumerate(ids.tolist()):
        for j in range(w):
            if mask[r, j]:
                g, m, v = grads[r, j], want[i, w + j], want[i, 2 * w + j]
                m_new = 0.9 * m + (1 - 0.9) * g
                v_new = 0.999 * v + (1 - 0.999) * (g * g)
                want[i, j] += (-lr * (m_new / denoms[0])) / (torch.sqrt(v_new / denoms[1]) + 1e-8)
                want[i, w + j], want[i, 2 * w + j] = m + (m_new - m), v + (v_new - v)
    before = fused_rowadam_packed.launches
    got = fused_rowadam_packed(packed.clone(), tables, ids, grads, denoms, lr)
    assert fused_rowadam_packed.launches == before  # the CPU takes the plain version
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_packed_bf16_plain_version_keeps_untouched_bytes():
    packed32, ids, grads = _packed_case(2)
    w = 6
    tables = [(0, 12, 0, 4), (12, 18, 0, 6)]
    packed = repack16(packed32[:, :w], 0.01 * packed32[:, w:2 * w], packed32[:, 2 * w:])
    before_bytes = packed.clone()
    before = fused_rowadam_packed_bf16.launches
    got = fused_rowadam_packed_bf16(packed, tables, ids, grads, bias_denominators(2), 0.05)
    assert fused_rowadam_packed_bf16.launches == before
    mask = _touched_by_loop(tables, ids, grads)
    moved = torch.zeros(30, w, dtype=torch.bool)
    for r, i in enumerate(ids.tolist()):
        moved[i] |= mask[r] > 0
    cells = moved.repeat(1, 4)
    assert torch.equal(got[~cells], before_bytes[~cells])
    p_before, _, _ = unpack16_components(before_bytes, w)
    p_after, _, _ = unpack16_components(got, w)
    assert bool((p_after[moved] != p_before[moved]).all())


def test_packed_wrapper_checks_its_inputs():
    packed = torch.zeros(10, 12)
    with pytest.raises(ValueError, match="overlap"):
        RowAdamPacked(packed, [(0, 6, 0, 3), (5, 5, 2, 2)])
    with pytest.raises(ValueError, match="outside"):
        RowAdamPacked(packed, [(0, 11, 0, 4)])
    with pytest.raises(ValueError, match="int16"):
        RowAdamPacked(packed, [(0, 10, 0, 3)], bf16=True)
    with pytest.raises(ValueError, match="1 to 8"):
        RowAdamPacked(packed, [(i, 1, 0, 1) for i in range(9)])
    group = RowAdamPacked(packed, [(0, 10, 0, 4)])
    with pytest.raises(ValueError, match=r"grads must be \(L, d\)"):
        group(torch.arange(3), torch.zeros(3, 3), bias_denominators(1), 0.1)
    with pytest.raises(TypeError, match="int64"):
        group(torch.arange(3, dtype=torch.int32), torch.zeros(3, 4), bias_denominators(1), 0.1)


def test_packed_call_struct_has_the_c_layout():
    source = (Path(rowadam.__file__).parents[2] / "csrc" / "rowadam.cu").read_text()
    for struct, ours in (("PackedRect", rowadam._PackedRect), ("RowAdamPackedCall", rowadam._RowAdamPackedCall)):
        body = re.search(rf"struct {struct} \{{(.*?)\}};", source, re.S).group(1)
        assert re.findall(r"(\w+)(?:\[kMaxTables\])?;", body) == [name for name, _ in ours._fields_]
    assert ctypes.sizeof(rowadam._PackedRect) == 24
    call = rowadam._RowAdamPackedCall
    assert (call.total_rows.offset, call.n_ids.offset, call.count.offset, call.t.offset) == (24, 32, 40, 48)
    assert (call.lr.offset, call.d2.offset, ctypes.sizeof(call)) == (240, 268, 272)


def test_bias_denominators_match_jax_float32():
    for step in (1, 2, 7, 246, 10_000):
        want = [float(1 - jnp.float32(b) ** jnp.float32(step)) for b in (0.9, 0.999)]
        np.testing.assert_allclose(bias_denominators(step), want, rtol=2e-7)


# -- the engine -------------------------------------------------------------------


@pytest.mark.parametrize("row_update", ["unified", "compact", "unified_bf16"])
def test_each_layout_trains_and_the_jax_package_loads_the_checkpoint(split, tmp_path, row_update):
    data, jax_data = _both_data(split)
    model = {"sparse_optim": True, "row_update": row_update}
    rec = MatrixFactorization(Config(_config(tmp_path / "port", **model)), device="cpu")
    result = rec.train(data)
    ours = rec.test()
    assert rec.engine.epoch_fn.row_update == row_update
    # Random ranking over 21 candidates gives ndcg@10 ~0.20 (tests/test_torch_train_mf.py).
    assert result["valid_metric"] > 0.35 and ours["ndcg@10"] > 0.35, (result, ours)
    raw = load_raw_checkpoint(result["model_save_dir"])
    assert int(raw["dropped"]) == 0 and raw["opt_state"]["0"]["count"] > 0
    jax_cfg = JaxConfig(json.loads(json.dumps(_config(tmp_path / "jax", **model))))
    want = JaxMatrixFactorization(jax_cfg).load(result["model_save_dir"], jax_data).test()
    for key in want:
        np.testing.assert_allclose(ours[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)


def _engine(tmp_path, data, **model):
    config = Config(_config(tmp_path, sparse_optim=True, **model))
    built = build_model(config.model, data.n_users, data.n_items, {}, "cpu")
    return TrainEngine(config, "cpu").build(built, data)


def test_compact_drops_warn_after_every_epoch_that_dropped(split, tmp_path, capsys):
    """One device: each epoch whose steps dropped rows at the compact
    capacity prints the JAX engine's warning once; an epoch that dropped
    none prints nothing. The count goes into the checkpoint and comes back
    on resume."""
    data, _ = _both_data(split)
    engine = _engine(tmp_path, data, row_update="compact", max_epoch=3, max_n_update=100)
    engine.epoch_fn.compact_capacity = 16
    engine.train(verbose=False)
    out = capsys.readouterr().out
    assert out.count("WARNING: sharded-sparse bucketed exchange dropped") == 3
    dropped = int(engine.epoch_fn.dropped)
    assert dropped > 0 and engine.dropped_grad_rows == dropped
    assert f"(cumulative {dropped})" in out
    assert "compact_capacity (16)" in out and "capacity_factor" not in out
    raw = load_raw_checkpoint(os.path.join(engine.checkpoint_dir, "last"))
    assert int(raw["dropped"]) == dropped
    resumed = _engine(tmp_path / "resumed", data, row_update="compact", max_epoch=4, max_n_update=100)
    resumed.epoch_fn.compact_capacity = 3 * 128  # the step's 3B ids at _config's batch: no more drops
    assert resumed.resume_training(engine.checkpoint_dir) == 3
    assert int(resumed.epoch_fn.dropped) == resumed.dropped_grad_rows == dropped
    resumed.train(verbose=False)
    assert "WARNING" not in capsys.readouterr().out and int(resumed.epoch_fn.dropped) == dropped


@pytest.mark.parametrize("row_update", ["unified", "unified_bf16"])
def test_while_packed_the_packed_array_is_the_only_copy(split, row_update):
    """Inside an epoch the packed tables' and moments' own storage is
    released (the optimizer state takes the layout's bytes); after it they
    hold the packed values again. Under "unified_bf16" the 1-D biases keep
    theirs."""
    data, _ = _both_data(split)
    cfg, _, _, ours = _models(data)
    trainer = _trainer(data, cfg, ours, row_update)
    packed_names = {name for name, *_ in trainer.layout.columns}
    assert packed_names == ({"user_emb", "item_emb"} if row_update == "unified_bf16" else set(ours.row_tables()))
    before = {name: (p.detach().clone(), *(x.clone() for x in trainer.state["moments"][name]))
              for name, p in trainer.tables.items()}
    with trainer._packed_epoch():
        for name, p in trainer.tables.items():
            sizes = [t.untyped_storage().nbytes() for t in (p, *trainer.state["moments"][name])]
            assert (sizes == [0, 0, 0]) == (name in packed_names), (name, sizes)
    for name, p in trainer.tables.items():  # no step: the values come back bit for bit (the moments are 0)
        for got, want in zip((p.detach(), *trainer.state["moments"][name]), before[name]):
            assert torch.equal(got, want), name
