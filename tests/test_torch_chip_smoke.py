"""chip_smoke.py's helpers, and its refusal to report without a card."""

import fnmatch
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from beta_recsys_tpu_torch.utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_ORDER_COL,
    DEFAULT_PREDICTION_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ml1m_shaped_split_is_leave_one_out():
    n_users, n_items, total = 40, 120, 2000
    train, (valid,), (test,) = chip_smoke.ml1m_shaped_split(
        1, n_users=n_users, n_items=n_items, n_interactions=total, max_per_user=90, n_negative=10
    )
    assert len(train[DEFAULT_USER_COL]) + 2 * n_users == total
    seen = set(zip(train[DEFAULT_USER_COL].tolist(), train[DEFAULT_ITEM_COL].tolist()))
    assert len(seen) == len(train[DEFAULT_USER_COL])  # no repeated (user, item)
    last_train = {}
    for u, t in zip(train[DEFAULT_USER_COL].tolist(), train[DEFAULT_TIMESTAMP_COL].tolist()):
        last_train[u] = max(last_train.get(u, t), t)
    for frame in (valid, test):
        pos = frame[DEFAULT_RATING_COL] == 1
        assert sorted(frame[DEFAULT_USER_COL][pos].tolist()) == list(range(1, n_users + 1))
        assert ((~pos).sum()) == 10 * n_users
        for u, i in zip(frame[DEFAULT_USER_COL][~pos].tolist(), frame[DEFAULT_ITEM_COL][~pos].tolist()):
            assert (u, i) not in seen
        for u, t in zip(frame[DEFAULT_USER_COL][pos].tolist(), frame[DEFAULT_TIMESTAMP_COL][pos].tolist()):
            assert t >= last_train[u]  # the held-out positives are the newest
    counts = np.bincount(train[DEFAULT_USER_COL])[1:] + 2
    assert counts.min() >= 20 and counts.max() <= 90


def test_attention_bound():
    ms, by = chip_smoke.attention_bound(1886, 100, 32, torch.float32)
    assert by == "bytes" and ms == pytest.approx(1886 * 100 * (4 * 32 * 4 + 4) / 3.35e12 * 1e3)
    ms, by = chip_smoke.attention_bound(12080, 200, 32, torch.float32)
    assert by == "operations" and ms == pytest.approx(4 * 32 * 12080 * 200 * 201 / 2 / 67e12 * 1e3)


def test_attention_bwd_bound():
    """The backward reads q, k, v, dout, lse and writes dq, dk, dv;
    ~10 * dh FLOPs a visible pair. At the training shape bytes bound it, at
    the shipped config's T = 200 the operations do."""
    ms, by = chip_smoke.attention_bwd_bound(256, 100, 32, torch.float32)
    assert by == "bytes" and ms == pytest.approx(256 * 100 * (7 * 32 * 4 + 4) / 3.35e12 * 1e3)
    ms, by = chip_smoke.attention_bwd_bound(256, 200, 32, torch.float32)
    assert by == "operations" and ms == pytest.approx(10 * 32 * 256 * 200 * 201 / 2 / 67e12 * 1e3)


def test_sasrec_config_is_the_trained_checkpoints():
    cfg = chip_smoke.sasrec_config(3, "/nowhere", num_heads=1)
    assert cfg.system.seed == 3 and cfg.system.root_dir == "/nowhere"
    assert cfg.dataset.dataset == "synthetic_structured" and cfg.dataset.n_test == 1
    m = cfg.model
    assert (m.emb_dim, m.num_blocks, m.num_heads, m.maxlen, m.batch_size) == (64, 2, 1, 100, 128)
    assert (m.lr, m.dropout_rate, m.l2_emb, m.max_n_update, m.max_epoch) == (1e-3, 0.1, 0.0, 20, 200)


def test_ring_bound():
    """Loopback: the card reads n blocks and writes n * n. Across cards: each
    card receives n - 1 blocks over NVLink (450 GB/s), which bounds it above
    its own HBM traffic (1 + n blocks)."""
    block = 200 * 64 * 4
    ms, by = chip_smoke.ring_bound(4, 200, 64, torch.float32, across=False)
    assert by == "bytes" and ms == pytest.approx((4 + 16) * block / 3.35e12 * 1e3)
    ms, by = chip_smoke.ring_bound(4, 200, 64, torch.float32, across=True)
    assert by == "bytes" and ms == pytest.approx(3 * block / 450e9 * 1e3)
    ms, _ = chip_smoke.ring_bound(8, 8192, 64, torch.bfloat16, across=False)
    assert ms == pytest.approx((8 + 64) * 8192 * 64 * 2 / 3.35e12 * 1e3)


def test_mesh_config_is_the_slice():
    cfg = chip_smoke.mesh_config(2, "/nowhere", (2, 2), max_epoch=3)
    assert cfg.system.mesh == {"data": 2, "model": 2} and cfg.system.seed == 2
    m = cfg.model
    assert (m.emb_dim, m.batch_size, m.lr, m.reg, m.max_epoch) == (64, 400, 0.05, 0.001, 3)
    assert (m.sparse_optim, m.lookup_strategy, m.capacity_factor) == (True, "ring", chip_smoke.MESH_CAPACITY_FACTOR)


def test_well_conditioned_weights_repeat():
    from beta_recsys_tpu_torch.models.mf import MF

    a, b = (chip_smoke.well_conditioned(MF({"emb_dim": 8}, 30, 20, device="cpu"), 4) for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert float(a.global_bias.detach()) == pytest.approx(0.3) and float(a.user_emb.detach().std()) > 0.5


def test_rowadam_bound():
    ms, by = chip_smoke.rowadam_bound(700, 64, 800)
    assert by == "bytes" and ms == pytest.approx((700 * 7 * 64 * 4 + 800 * 8) / 3.35e12 * 1e3)


@pytest.mark.parametrize("bf16", [False, True])
def test_packed_bound(bf16):
    ms, by = chip_smoke.packed_bound(600, 65, 768, bf16)
    row_bytes = 4 * 65 * 2 * 2 if bf16 else 6 * 65 * 4
    assert by == "bytes" and ms == pytest.approx((600 * row_bytes + 768 * (65 * 4 + 8)) / 3.35e12 * 1e3)


@pytest.mark.parametrize("bf16", [False, True])
def test_packed_read_bound(bf16):
    """What a write that skips duplicates reads: every id, the first
    occurrences' gradient rows and the touched rows, read and written; never
    above the bound that reads every gradient row."""
    ms = chip_smoke.packed_read_bound(300, 250, 65, 768, bf16)
    row_bytes = 4 * 65 * 2 * 2 if bf16 else 6 * 65 * 4
    assert ms == pytest.approx((250 * row_bytes + 300 * 65 * 4 + 768 * 8) / 3.35e12 * 1e3)
    assert ms < chip_smoke.packed_bound(250, 65, 768, bf16)[0]


def test_first_occurrences():
    assert chip_smoke.first_occurrences(torch.tensor([1, 1, 2, 5, 5, 5, 9])) == 4
    assert chip_smoke.first_occurrences(torch.tensor([3])) == 1
    assert chip_smoke.first_occurrences(torch.tensor([], dtype=torch.int64)) == 0


@pytest.mark.parametrize("bf16", [False, True])
def test_packed_inputs_are_one_mf_step(bf16):
    """MF's packed layout (embeddings and, in float32, a bias column a role),
    B user ids and 2B item ids at their row offsets, sorted and deduplicated,
    every 7th gradient row zero; the layouts' bands can fail an untrained model."""
    layout, packed, ids, grads = chip_smoke.packed_inputs(40, 30, 8, 16, True, 0, bf16, device="cpu")
    assert layout.w == (8 if bf16 else 9) and layout.total_rows == 70
    assert packed.shape == (70, (4 if bf16 else 3) * layout.w)
    assert packed.dtype == (torch.int16 if bf16 else torch.float32)
    assert ids.shape == (48,) and bool((ids[1:] >= ids[:-1]).all()) and int(ids.max()) < 70
    assert grads.shape == (48, layout.w)
    assert chip_smoke.MF_SPARSE_EPOCHS == 5
    for layout_name in chip_smoke.LAYOUTS:
        band = chip_smoke.layout_band(layout_name)
        assert band["valid"][0] - 3 * band["valid"][1] > chip_smoke.UNTRAINED_NDCG


@pytest.mark.parametrize("zipf", [False, True])
def test_rowadam_inputs_hold_every_case(zipf):
    """Duplicate ids, all-zero gradient rows and an id whose gradients cancel."""
    table, m, v, ids, grads = chip_smoke.rowadam_inputs(5000, 700, 8, 3, "cpu", zipf=zipf)
    assert table.shape == m.shape == v.shape == (5000, 8) and grads.shape == (700, 8)
    assert (v >= 0).all() and int(ids.min()) >= 0 and int(ids.max()) < 5000
    assert len(torch.unique(ids)) < len(ids)
    assert not grads[::7].any()
    cancel = ids[-1]
    assert ids[-2] == cancel and (ids == cancel).sum() == 2 and grads[-2].any()
    _, summed = chip_smoke._segment_dedup(ids, grads)
    assert (summed != 0).any(dim=1).sum() < len(torch.unique(ids))


def test_in_band_fails_outside_mean_plus_minus_three_std():
    assert "in [0.1700, 0.2300]" in chip_smoke.in_band("ndcg", 0.2, (0.2, 0.01))
    with pytest.raises(SystemExit):
        chip_smoke.in_band("ndcg", 0.2301, (0.2, 0.01))


def test_mf_config_is_the_default_on_the_parity_split():
    cfg = chip_smoke.mf_config(1, "/nowhere", sparse_optim=True, row_update="fused")
    assert cfg.system.seed == 1 and cfg.dataset.dataset == "synthetic_structured" and cfg.dataset.n_test == 1
    assert (cfg.model.emb_dim, cfg.model.batch_size, cfg.model.lr, cfg.model.reg) == (64, 400, 0.05, 0.001)
    assert (cfg.model.max_epoch, cfg.model.max_n_update, cfg.model.row_update) == (200, 20, "fused")


def _recs(items, scores):
    items, scores = np.asarray(items), np.asarray(scores, dtype=np.float32)
    return {DEFAULT_ITEM_COL: items.reshape(-1), DEFAULT_PREDICTION_COL: scores.reshape(-1)}


def test_same_top_k_allows_only_near_ties():
    ref = _recs([[1, 2, 3]], [[3.0, 2.0, 2.0]])
    assert chip_smoke.same_top_k(ref, ref, 3) == 0
    assert chip_smoke.same_top_k(_recs([[1, 3, 2]], [[3.0, 2.0, 2.0]]), ref, 3) == 1
    with pytest.raises(SystemExit):
        chip_smoke.same_top_k(_recs([[2, 1, 3]], [[3.0, 3.0, 2.0]]), _recs([[1, 2, 3]], [[3.0, 2.5, 2.0]]), 3)


def test_refuses_outside_the_repo_and_without_cuda(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    runs = [(str(lone), tmp_path)]
    if not torch.cuda.is_available():
        runs.append((os.path.join(REPO, "chip_smoke.py"), REPO))
    for script, cwd in runs:
        out = subprocess.run([sys.executable, script], capture_output=True, text=True, timeout=120, cwd=cwd)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("name,emb_dim", [("GMF", 64), ("MLP", 8), ("NCF", 8)])
def test_ncf_config_is_the_shipped_config(name, emb_dim):
    cfg = chip_smoke.ncf_config(name, 3, "/nowhere")
    assert cfg.system.seed == 3 and cfg.system.root_dir == "/nowhere"
    assert cfg.dataset.dataset == "synthetic_structured" and cfg.dataset.n_test == 1
    m = cfg.model
    assert (m.model, m.emb_dim, m.num_negative, m.batch_size, m.lr, m.max_n_update) == (name, emb_dim, 4, 400, 1e-3, 20)
    assert m.max_epoch == chip_smoke.NCF_EPOCHS == 8
    assert set(chip_smoke.NCF_BANDS[name]) == {"valid", "test"}
    assert os.path.isdir(os.path.join(REPO, "parity_runs/checkpoints", chip_smoke.NCF_FAMILY[name][2]))


@pytest.mark.parametrize("name,keep,lr", [("LightGCN", 0.6, 2.5e-4), ("NGCF", None, 0.01)])
def test_graph_config_is_the_shipped_config(name, keep, lr):
    cfg = chip_smoke.graph_config(name, 3, "/nowhere")
    assert cfg.system.seed == 3 and cfg.system.root_dir == "/nowhere"
    assert cfg.dataset.dataset == "synthetic_structured" and cfg.dataset.n_test == 1
    m = cfg.model
    assert (m.emb_dim, m.layer_size, m.batch_size, m.lr, m.max_n_update) == (64, [64, 64, 64], 1024, lr, 20)
    assert m.get("keep_pro") == keep and chip_smoke.graph_config(name, 3, "/x", max_epoch=3).model.max_epoch == 3
    band = chip_smoke.GRAPH_BANDS[name]
    assert set(band) == {"valid", "test"} and all(0 < std < 0.02 for _, std in band.values())
    assert os.path.isdir(chip_smoke.graph_checkpoint(name))


def test_sparse_route_repeats_reports_each_product():
    """On the CPU the CSR products repeat bit for bit: every difference 0."""
    from beta_recsys_tpu_torch.ops.graph import pack_propagator

    rng = np.random.default_rng(0)
    pairs = np.unique(rng.integers(0, 30, (120, 2)), axis=0)
    prop = pack_propagator(pairs[:, 0], pairs[:, 1], rng.uniform(size=len(pairs)), 30, fmt="chunked", device="cpu")
    repeats = chip_smoke.sparse_route_repeats(prop, 0, d=8)
    assert list(repeats) == ["A @ x", "A^T @ g", "A @ x (dropped edges)", "A^T @ g (dropped edges)"]
    assert not any(repeats.values())


@pytest.mark.parametrize("name,cap,batch,optimizer", [("UltraGCN", 10, 1024, "adam"), ("MixGCF", 5, 1024, "adam"),
                                                      ("PairwiseGMF", 5, 128, "adam"), ("CMN", 3, 128, "rmsprop")])
def test_capped_config_is_the_shipped_config_at_its_cap(name, cap, batch, optimizer):
    cfg = chip_smoke.capped_config(name, 3, "/nowhere")
    assert cfg.system.seed == 3 and cfg.system.root_dir == "/nowhere"
    assert cfg.dataset.dataset == "synthetic_structured" and cfg.dataset.n_test == 1
    m = cfg.model
    assert (m.model, m.max_epoch, m.batch_size, m.optimizer, m.lr, m.max_n_update) == (name, cap, batch, optimizer,
                                                                                       1e-3, 20)
    assert chip_smoke.capped_config(name, 3, "/x", max_epoch=2).model.max_epoch == 2
    band = chip_smoke.CAPPED_BANDS[name]
    assert set(band) == {"valid", "test"} and all(0 < mean < 0.3 and 0 < std < 0.1 for mean, std in band.values())


def test_the_served_ultragcn_checkpoint_is_in_the_repo_and_the_chip_copy():
    path = os.path.join(REPO, "parity_runs/checkpoints", chip_smoke.ULTRAGCN_CHECKPOINT)
    assert os.path.exists(os.path.join(path, "checkpoint.msgpack"))
    with open(os.path.join(REPO, ".chiprunignore")) as f:
        ignored = [line.strip() for line in f if line.strip() and not line.startswith("#")]
    assert not any(fnmatch.fnmatch("parity_runs/checkpoints/" + chip_smoke.ULTRAGCN_CHECKPOINT, pattern)
                   for pattern in ignored)
    assert any("UltraGCN" in pattern for pattern in ignored)  # the other seeds stay out


def test_cmn_steps_match_cpu_compares_loss_parameters_and_nu(tmp_path, monkeypatch):
    """Both sides on the CPU at a narrow width agree within the limit (not
    bit for bit: threaded CPU sums part by ~1e-9), and a limit below 0
    fails."""
    data = chip_smoke.mf_split()
    start = chip_smoke.CMN(chip_smoke.capped_config("CMN", 0, str(tmp_path), emb_dim=4), device="cpu")
    start.data = data
    engine = chip_smoke.TrainEngine(start.config, start.device).build(
        start._build_model(data.n_users, data.n_items), data)
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    report = chip_smoke.cmn_steps_match_cpu("cmn-train", start, engine, data, steps=2)
    assert "emb 4, 2 hops over neighbourhoods 614 users wide" in report and "max |d| loss " in report
    assert any(not torch.equal(before[k], v) for k, v in engine.model.state_dict().items())  # the steps ran
    monkeypatch.setattr(chip_smoke, "CMN_CPU_TOL", -1.0)
    with pytest.raises(SystemExit):
        chip_smoke.cmn_steps_match_cpu("cmn-train", start, engine, data, steps=1)


@pytest.mark.parametrize("name", ["MF", "GMF", "UltraGCN"])
def test_profile_window_forms_the_batches_inside_it(name, tmp_path, monkeypatch):
    """The profiled callable draws the epoch's permutation and negatives
    (the generator advances inside it) and trains ``steps`` steps."""
    data = chip_smoke.mf_split()
    if name == "MF":
        rec = chip_smoke.MatrixFactorization(chip_smoke.mf_config(0, str(tmp_path), emb_dim=4), device="cpu")
    elif name == "GMF":
        rec = chip_smoke.GMFRecommender(chip_smoke.ncf_config("GMF", 0, str(tmp_path)), device="cpu")
    else:
        rec = chip_smoke.UltraGCN(chip_smoke.capped_config(name, 0, str(tmp_path), emb_dim=4), device="cpu")
    rec.data = data
    engine = chip_smoke.TrainEngine(rec.config, rec.device).build(rec._build_model(data.n_users, data.n_items), data)
    trainer, generator = engine.epoch_fn, engine.generator
    seen = {}

    def breakdown(fn, steps=None, **kwargs):
        state = generator.get_state()
        seen["loss"], seen["steps"] = fn(), steps
        seen["drew"] = not torch.equal(state, generator.get_state())
        return "profiled"

    monkeypatch.setattr(chip_smoke, "device_breakdown", breakdown)
    calls = []
    run_batches = trainer.run_batches
    monkeypatch.setattr(trainer, "run_batches", lambda *a, **k: calls.append(a[0].shape) or run_batches(*a, **k))
    assert chip_smoke.profile_window(trainer, generator, 3) == "profiled"
    assert seen["drew"] and seen["steps"] == 3 and np.isfinite(seen["loss"]) and calls == [(3, trainer.batch_size)]


@pytest.mark.parametrize("name,layers", [("SimGCL", ("n_layer", 3)), ("SGL", ("n_layers", 3)),
                                         ("BUIR", ("n_layers", 3)), ("LCFN", ("layer", 1))])
def test_ssl_config_is_the_shipped_config_at_its_cap(name, layers):
    cfg = chip_smoke.ssl_config(name, 3, "/nowhere")
    m = cfg.model
    assert (cfg.system.seed, cfg.dataset.dataset, cfg.dataset.n_test) == (3, "synthetic_structured", 1)
    assert (m.model, m.emb_dim, m.batch_size, m.optimizer, m.lr) == (name, 64, 1024, "adam", 0.001)
    assert m.get(layers[0]) == layers[1] and m.max_epoch == chip_smoke.SSL_FAMILY[name][2]
    assert chip_smoke.ssl_config(name, 3, "/x", max_epoch=2).model.max_epoch == 2
    band = chip_smoke.SSL_BANDS[name]
    assert set(band) == {"valid", "test"} and all(0 < mean < 1 and 0 < std < 0.1 for mean, std in band.values())
    # Only BUIR's band can fail an untrained model; the other three are held by their steps.
    weak = any(mean - 3 * std < chip_smoke.UNTRAINED_NDCG for mean, std in band.values())
    assert weak == (name != "BUIR")


def test_band_position_reports_without_failing():
    assert chip_smoke.band_position("ndcg", 0.2, (0.2, 0.01)) == "ndcg 0.200000 in [0.1700, 0.2300]"
    assert "OUTSIDE [0.1700, 0.2300]" in chip_smoke.band_position("ndcg", 0.2301, (0.2, 0.01))


@pytest.mark.parametrize("name", ["SGL", "SimGCL"])
def test_steps_match_cpu_hands_the_card_draws_to_the_cpu(name, tmp_path, monkeypatch):
    """Both runs on the CPU at a narrow width: with the draws replayed they
    agree within the limit, each run draws anew without the replay (so the
    steps differ), SGL builds two dense A's a step, and a limit below 0
    fails. The draw functions come back after the block."""
    data = chip_smoke.mf_split()
    start, engine = chip_smoke.ssl_engine(name, 0, str(tmp_path), data, "cpu", emb_dim=4)
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    real = (chip_smoke.sgl_model.sgl_draws, chip_smoke.simgcl_model.perturbation_noise)
    diff, rebuilds, _ = chip_smoke.steps_match_cpu(f"{name}-train", start, engine, data, 2, chip_smoke.SSL_CPU_TOL)
    assert (chip_smoke.sgl_model.sgl_draws, chip_smoke.simgcl_model.perturbation_noise) == real
    assert set(diff) == {"loss", "parameters", "exp_avg", "exp_avg_sq"} and max(diff.values()) < 1e-5
    assert rebuilds == (2 if name == "SGL" else 0)
    assert any(not torch.equal(before[k], v) for k, v in engine.model.state_dict().items())  # the steps ran

    class NoReplay(chip_smoke.DrawReplay):
        def __enter__(self):
            return self

    monkeypatch.setattr(chip_smoke, "DrawReplay", NoReplay)
    monkeypatch.setattr(chip_smoke, "fail", lambda msg: (_ for _ in ()).throw(AssertionError(msg)))
    with pytest.raises(AssertionError, match="steps differ from the CPU's"):
        chip_smoke.steps_match_cpu(f"{name}-train", start, engine, data, 1, chip_smoke.SSL_CPU_TOL)
    monkeypatch.undo()
    with pytest.raises(SystemExit):
        chip_smoke.steps_match_cpu(f"{name}-train", start, engine, data, 1, -1.0)


def test_buir_target_after_one_step_is_its_ema(tmp_path, monkeypatch):
    data = chip_smoke.mf_split()
    report = chip_smoke.buir_target_after_one_step("buir-train", 0, str(tmp_path), data, "cpu", emb_dim=4)
    assert "0.995 * initial + 0.005 * online" in report
    from beta_recsys_tpu_torch.models.buir import BUIR

    monkeypatch.setattr(BUIR, "post_update", lambda self: None)  # a trainer without the hook fails the check
    with pytest.raises(SystemExit):
        chip_smoke.buir_target_after_one_step("buir-train", 0, str(tmp_path), data, "cpu", emb_dim=4)


@pytest.mark.parametrize("where,passes", [((0, 0), True), ((0, 1), False)])
def test_steps_match_cpu_excuses_only_eps_set_elements(where, passes, tmp_path, monkeypatch):
    """An element whose gradient is 0 on both sides (set below eps after each
    step) may pass the limit; the same difference at an element with a
    gradient fails."""
    from beta_recsys_tpu_torch.core.train_engine import DenseEpochTrainer

    data = chip_smoke.mf_split()
    start, engine = chip_smoke.ssl_engine("SimGCL", 0, str(tmp_path), data, "cpu", emb_dim=4)
    real_step = DenseEpochTrainer.step

    def step(self, *args):
        loss = real_step(self, *args)
        self.model.user_emb.grad[0, 0] = 0.0
        return loss

    monkeypatch.setattr(DenseEpochTrainer, "step", step)
    real_run = engine.epoch_fn.run_batches

    def card_run(*args, **kwargs):
        loss = real_run(*args, **kwargs)
        with torch.no_grad():
            engine.model.user_emb[where] += 5e-5
        return loss

    monkeypatch.setattr(engine.epoch_fn, "run_batches", card_run)
    if passes:
        diff, _, report = chip_smoke.steps_match_cpu("simgcl-train", start, engine, data, 2, 1e-5, 1e-7)
        assert diff["parameters"] < 1e-5 and report.startswith("; 1 eps-set element(s) of ")
    else:
        with pytest.raises(SystemExit):
            chip_smoke.steps_match_cpu("simgcl-train", start, engine, data, 2, 1e-5, 1e-7)


@pytest.mark.parametrize("name,width,batch,cap", [("TiSASRec", ("emb_dim", 64), 128, 10),
                                                  ("NARM", ("hidden_size", 100), 512, 5),
                                                  ("VAECF", ("z_dim", 10), 128, 200)])
def test_seq_config_is_the_shipped_config_at_its_cap(name, width, batch, cap):
    cfg = chip_smoke.seq_config(name, 3, "/nowhere")
    m = cfg.model
    assert (cfg.system.seed, cfg.dataset.dataset, cfg.dataset.n_test) == (3, "synthetic_structured", 1)
    assert (m.model, m.batch_size, m.optimizer, m.lr, m.max_epoch, m.max_n_update) == (name, batch, "adam", 1e-3,
                                                                                        cap, 20)
    assert m.get(width[0]) == width[1] and chip_smoke.SEQ_FAMILY[name][2] == cap
    assert chip_smoke.seq_config(name, 3, "/x", max_epoch=2).model.max_epoch == 2
    band = chip_smoke.SEQ_BANDS[name]
    assert set(band) == {"valid", "test"} and all(0 < mean < 1 and 0 < std < 0.1 for mean, std in band.values())
    # Only TiSASRec's band reaches below random ranking: its steps hold it.
    weak = any(mean - 3 * std < chip_smoke.UNTRAINED_NDCG for mean, std in band.values())
    assert weak == (name == "TiSASRec")


def test_the_served_vaecf_checkpoint_is_in_the_repo_and_the_chip_copy():
    path = os.path.join(REPO, "parity_runs/checkpoints", chip_smoke.VAECF_CHECKPOINT)
    assert os.path.exists(os.path.join(path, "checkpoint.msgpack"))
    with open(os.path.join(REPO, ".chiprunignore")) as f:
        ignored = [line.strip() for line in f if line.strip() and not line.startswith("#")]
    assert not any(fnmatch.fnmatch("parity_runs/checkpoints/" + chip_smoke.VAECF_CHECKPOINT, pattern)
                   for pattern in ignored)
    others = [d for d in os.listdir(os.path.join(REPO, "parity_runs/checkpoints"))
              if d.startswith("VAECF_") and d != chip_smoke.VAECF_CHECKPOINT]
    assert others and all(any(fnmatch.fnmatch("parity_runs/checkpoints/" + d, p) for p in ignored) for d in others)


def test_steps_match_cpu_hands_the_dropout_masks_to_the_cpu(tmp_path, monkeypatch):
    """TiSASRec at a narrow width, both runs on the CPU: with the masks
    replayed they agree within the limit, without the replay each run draws
    its own masks (the steps differ), and the draw functions come back
    after the block."""
    data = chip_smoke.seq_split()
    start, engine = chip_smoke.seq_engine("TiSASRec", 0, str(tmp_path), data, "cpu", emb_dim=4)
    assert engine.model.dropout_rate == 0.2
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    real = (chip_smoke.port_attention.dropout_mask, chip_smoke.vaecf_model.latent_noise)
    diff, _, _ = chip_smoke.steps_match_cpu("tisasrec-train", start, engine, data, 2, chip_smoke.SSL_CPU_TOL,
                                            chip_smoke.SSL_EPS_SET)
    assert (chip_smoke.port_attention.dropout_mask, chip_smoke.vaecf_model.latent_noise) == real
    assert set(diff) == {"loss", "parameters", "exp_avg", "exp_avg_sq"} and max(diff.values()) < 1e-5
    assert any(not torch.equal(before[k], v) for k, v in engine.model.state_dict().items())  # the steps ran

    class NoReplay(chip_smoke.DrawReplay):
        def __enter__(self):
            return self

    monkeypatch.setattr(chip_smoke, "DrawReplay", NoReplay)
    monkeypatch.setattr(chip_smoke, "fail", lambda msg: (_ for _ in ()).throw(AssertionError(msg)))
    with pytest.raises(AssertionError, match="steps differ from the CPU's"):
        chip_smoke.steps_match_cpu("tisasrec-train", start, engine, data, 1, chip_smoke.SSL_CPU_TOL)


def test_draw_replay_hands_each_draw_function_its_recorded_draws():
    """Recorded draws (dropout masks, VAECF's noise) come back in order on
    the device each replaying call names."""
    with chip_smoke.DrawReplay() as replay:
        masks = [chip_smoke.port_attention.dropout_mask(torch.Generator().manual_seed(i), (3, 4), 0.5, "cpu")
                 for i in range(2)]
        noise = chip_smoke.vaecf_model.latent_noise(torch.Generator().manual_seed(5), (2, 3), "cpu")
        replay.replaying = True
        assert torch.equal(chip_smoke.port_attention.dropout_mask(None, (3, 4), 0.5, "cpu"), masks[0])
        assert torch.equal(chip_smoke.port_attention.dropout_mask(None, (3, 4), 0.5, "cpu"), masks[1])
        assert torch.equal(chip_smoke.vaecf_model.latent_noise(None, (2, 3), "cpu"), noise)
        assert not replay.queue


@pytest.mark.parametrize("name", ["TiSASRec", "NARM", "VAECF"])
def test_profile_window_takes_the_sequence_and_row_trainers(name, tmp_path, monkeypatch):
    """The profiled callable forms the epoch's batches (the generator
    advances inside it) and trains ``steps`` steps of each new trainer."""
    data = chip_smoke.seq_split()
    width = {"TiSASRec": {"emb_dim": 4}, "NARM": {"hidden_size": 4, "emb_dim": 4, "embedding_dim": 4},
             "VAECF": {}}[name]
    _, engine = chip_smoke.seq_engine(name, 0, str(tmp_path), data, "cpu", **width)
    trainer, generator = engine.epoch_fn, engine.generator
    seen = {}

    def breakdown(fn, steps=None, **kwargs):
        state = generator.get_state()
        seen["loss"], seen["steps"] = fn(), steps
        seen["drew"] = not torch.equal(state, generator.get_state())
        return "profiled"

    monkeypatch.setattr(chip_smoke, "device_breakdown", breakdown)
    calls = []
    run_batches = trainer.run_batches
    monkeypatch.setattr(trainer, "run_batches", lambda *a, **k: calls.append(a[0].shape) or run_batches(*a, **k))
    assert chip_smoke.profile_window(trainer, generator, 2) == "profiled"
    assert seen["drew"] and seen["steps"] == 2 and np.isfinite(seen["loss"]) and calls == [(2, trainer.batch_size)]


def test_serves_as_the_cpu_compares_metrics_scores_and_lists(tmp_path, monkeypatch):
    """The seed-0 VAECF checkpoint served twice on the CPU agrees with
    itself; a model whose parameters moved fails."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    data = chip_smoke.seq_split()
    path = os.path.join(REPO, "parity_runs/checkpoints", chip_smoke.VAECF_CHECKPOINT)
    cfg = chip_smoke.load_config(path).replace(system={"root_dir": str(tmp_path)})
    rec = chip_smoke.VAECF(cfg, device="cpu").load(path, data)
    res = rec.test()
    for key, want in chip_smoke.EXPECTED_VAECF_METRICS.items():
        assert abs(res[key] - want) < 1e-5, key
    report = chip_smoke.serves_as_the_cpu("vaecf-serve", rec, data, path, res)
    assert "test() within 0 of the CPU's, predict(300 pairs) within 0 (relative" in report
    with torch.no_grad():
        rec.model.dec[-1]["b"] += torch.linspace(0, 1, data.n_items)
    with pytest.raises(SystemExit):
        chip_smoke.serves_as_the_cpu("vaecf-serve", rec, data, path, rec.test())


def test_draw_replay_hands_the_ffn_relu_decisions_over():
    """The FFN's ReLU decisions of a recording run come back to a replaying
    run: a pre-activation on the other side of 0 takes the recorded branch."""
    from beta_recsys_tpu_torch.ops.attention import pointwise_ffn

    g = torch.Generator().manual_seed(0)
    p = {"w1": torch.randn(4, 4, generator=g), "b1": torch.zeros(4), "w2": torch.eye(4), "b2": torch.zeros(4)}
    x = torch.randn(3, 4, generator=g)
    with chip_smoke.DrawReplay() as replay:
        out = pointwise_ffn(x, p)
        assert torch.equal(out, x + torch.relu(x @ p["w1"]))
        replay.replaying = True
        flipped = pointwise_ffn(x, {**p, "w1": -p["w1"]})  # every sign flips; the recorded branches stay
        assert torch.equal(flipped, x - torch.where(x @ p["w1"] > 0, x @ p["w1"], 0.0))
        assert not replay.queue


@pytest.mark.parametrize("name,widths,lr,cap", [("Triple2vec", {"emb_dim": 64, "use_bias": True}, 5e-4, 5),
                                                ("VBCAR", {"emb_dim": 64, "late_dim": 128, "alpha": 0.05}, 1e-3, 5),
                                                ("TVBR", {"emb_dim": 64, "late_dim": 128, "time_step": 4}, 1e-3, 5)])
def test_grocery_config_is_the_shipped_config_at_its_cap(name, widths, lr, cap):
    cfg = chip_smoke.grocery_config(name, 3, "/nowhere")
    m = cfg.model
    assert (cfg.system.seed, cfg.dataset.dataset, cfg.dataset.n_test) == (3, "synthetic_structured", 1)
    assert (m.model, m.batch_size, m.optimizer, m.lr, m.max_epoch, m.n_sample, m.n_neg) == (
        name, 512, "adam", lr, cap, 100_000, 5)
    assert all(m.get(key) == value for key, value in widths.items())
    assert chip_smoke.grocery_config(name, 3, "/x", max_epoch=2).model.max_epoch == 2
    band = chip_smoke.GROCERY_BANDS[name]
    assert set(band) == {"valid", "test"} and all(0 < mean < 1 and 0 < std < 0.1 for mean, std in band.values())
    # Every band's lower edge lies far above random ranking: the bands hold the models.
    assert all(mean - 3 * std > chip_smoke.UNTRAINED_NDCG for mean, std in band.values())


def test_the_served_triple2vec_checkpoint_is_in_the_repo_and_the_chip_copy():
    path = os.path.join(REPO, "parity_runs/checkpoints", chip_smoke.TRIPLE2VEC_CHECKPOINT)
    assert os.path.exists(os.path.join(path, "checkpoint.msgpack"))
    with open(os.path.join(REPO, ".chiprunignore")) as f:
        ignored = [line.strip() for line in f if line.strip() and not line.startswith("#")]
    assert not any(fnmatch.fnmatch("parity_runs/checkpoints/" + chip_smoke.TRIPLE2VEC_CHECKPOINT, pattern)
                   for pattern in ignored)
    others = [d for d in os.listdir(os.path.join(REPO, "parity_runs/checkpoints"))
              if d.startswith("Triple2vec_") and d != chip_smoke.TRIPLE2VEC_CHECKPOINT]
    assert others and all(any(fnmatch.fnmatch("parity_runs/checkpoints/" + d, p) for p in ignored) for d in others)


def test_the_grocery_split_carries_the_parity_baskets():
    data = chip_smoke.grocery_split()
    train = chip_smoke.load_split_data(chip_smoke.SPLIT, n_test=1)[0]
    orders = data.train[DEFAULT_ORDER_COL]
    assert np.array_equal(orders // 100_000, train[DEFAULT_USER_COL])
    assert np.bincount(np.unique(orders, return_inverse=True)[1]).max() == 5
    assert (data.n_users, data.n_items) == (943, 1682)


@pytest.fixture
def none_is_the_cpu(monkeypatch):
    """Recommenders and models built without a device go to the CPU, and
    the card's synchronisation and memory counters do nothing."""
    from beta_recsys_tpu_torch.core import recommender
    from beta_recsys_tpu_torch.models import base

    for module in (recommender, base):
        monkeypatch.setattr(module, "resolve_device", lambda device=None: torch.device(device or "cpu"))
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)


def test_phase_31_serves_the_jax_metrics_on_the_cpu(tmp_path, none_is_the_cpu):
    """The Triple2vec checkpoint and the two KNN models served on the CPU
    give the JAX package's metrics that the card is held to (1e-6), with
    no kernel; a moved constant fails."""
    data = chip_smoke.grocery_split()
    counts = chip_smoke.serve_grocery_and_knn(0, str(tmp_path), data)
    assert set(counts) == {"triple2vec-serve", "userknn-serve", "itemknn-serve"}
    assert not any(any(c.values()) for c in counts.values())
    wrong = {**chip_smoke.EXPECTED_KNN_METRICS["UserKNN"], "ndcg@10": 0.3826548}
    with pytest.raises(SystemExit):
        chip_smoke.held_to("userknn-serve", chip_smoke.EXPECTED_KNN_METRICS["UserKNN"], wrong, "UserKNN")


def test_grocery_training_runs_its_checks_on_the_cpu(tmp_path, monkeypatch, none_is_the_cpu):
    """Triple2vec through phase 32's checks on the CPU at a narrow width and
    2,000 triples, one epoch: with a band that reaches below random ranking
    the first steps are held to a second run (the CPU against itself), the
    band is reported, the trained model serves as the CPU serves it, and
    two more trainings repeat bit for bit."""
    real = chip_smoke.shipped_config
    monkeypatch.setattr(chip_smoke, "shipped_config", lambda path, seed, root, **model: real(
        path, seed, root, **{"n_sample": 2000, "emb_dim": 8, **model}))
    monkeypatch.setitem(chip_smoke.GROCERY_FAMILY, "Triple2vec", (chip_smoke.Triple2vec,
                                                                  "configs/triple2vec_default.json", 1))
    monkeypatch.setitem(chip_smoke.GROCERY_BANDS, "Triple2vec", {"valid": (0.05, 0.01), "test": (0.05, 0.01)})
    monkeypatch.setattr(chip_smoke, "GROCERY_REPEAT_EPOCHS", 1)
    logged = []
    monkeypatch.setattr(chip_smoke, "log", lambda phase, msg: logged.append(msg))
    counts = chip_smoke.grocery_training("Triple2vec", 0, str(tmp_path), chip_smoke.grocery_split())
    assert not any(counts.values())
    text = "\n".join(logged)
    assert "5 Adam steps at emb 8" in text and "2000 triples drawn from the seed" in text
    assert "reported, not held" in text and "the CPU's lists for every user" in text
    assert "gave the same best and last parameters" in text


def test_a_repeat_is_held_against_a_training_whose_best_epoch_ends_it(tmp_path, monkeypatch, none_is_the_cpu):
    """A longer training whose best epoch is the repeat's last stands in for
    one of the two repeats: one more training is held against its best
    checkpoint and history, and a changed best checkpoint fails it."""
    monkeypatch.setattr(chip_smoke, "log", lambda phase, msg: None)
    data = chip_smoke.grocery_split()

    def train(phase, epochs):
        cfg = chip_smoke.grocery_config("Triple2vec", 0, str(tmp_path), max_epoch=epochs, n_sample=2000, emb_dim=8)
        return chip_smoke.train_dense(chip_smoke.Triple2vec(cfg), phase, data)

    rec, result, _, _ = train("triple2vec-train", 1)
    assert result["best_epoch"] == 0
    ran = []
    chip_smoke.repeats_bit_for_bit("Triple2vec", "p", 0, 1, lambda p, e: ran.append(e) or train(p, e),
                                   chip_smoke.flatten_params, main=(rec, result))
    assert ran == [1]
    with torch.no_grad():
        rec.model.user_emb.add_(1e-6)
    with pytest.raises(SystemExit):
        chip_smoke.repeats_bit_for_bit("Triple2vec", "p", 0, 1, train, chip_smoke.flatten_params, main=(rec, result))


def test_steps_match_cpu_hands_vbcars_latent_noise_over(tmp_path):
    """VBCAR and TVBR at a narrow width, both runs on the CPU: with the
    noise replayed the steps agree within the limit, and the draw function
    comes back after the block."""
    data = chip_smoke.grocery_split()
    for name in ("VBCAR", "TVBR"):
        start, engine = chip_smoke.grocery_engine(name, 0, str(tmp_path), data, "cpu", emb_dim=4, late_dim=4,
                                                  n_sample=3000)
        real = chip_smoke.vbcar_model.latent_noise
        diff, _, _ = chip_smoke.steps_match_cpu(f"{name.lower()}-train", start, engine, data, 2,
                                                chip_smoke.SSL_CPU_TOL, chip_smoke.SSL_EPS_SET)
        assert chip_smoke.vbcar_model.latent_noise is real
        assert set(diff) == {"loss", "parameters", "exp_avg", "exp_avg_sq"} and max(diff.values()) < 1e-5


@pytest.mark.parametrize("name", ["Triple2vec", "TVBR"])
def test_profile_window_takes_the_triple_trainer(name, tmp_path, monkeypatch):
    """The profiled callable forms the epoch's order and negatives (the
    generator advances inside it) and trains ``steps`` steps."""
    data = chip_smoke.grocery_split()
    _, engine = chip_smoke.grocery_engine(name, 0, str(tmp_path), data, "cpu", emb_dim=4, late_dim=4,
                                          n_sample=3000)
    trainer, generator = engine.epoch_fn, engine.generator
    seen = {}

    def breakdown(fn, steps=None, **kwargs):
        state = generator.get_state()
        seen["loss"], seen["steps"] = fn(), steps
        seen["drew"] = not torch.equal(state, generator.get_state())
        return "profiled"

    monkeypatch.setattr(chip_smoke, "device_breakdown", breakdown)
    calls = []
    run_batches = trainer.run_batches
    monkeypatch.setattr(trainer, "run_batches", lambda *a, **k: calls.append([x.shape for x in a]) or run_batches(
        *a, **k))
    assert chip_smoke.profile_window(trainer, generator, 2) == "profiled"
    b = trainer.batch_size
    assert seen["drew"] and seen["steps"] == 2 and np.isfinite(seen["loss"])
    assert calls == [[(2, b), (2, b, 5), (2, b, 5), (2, b, 5)]]


def test_expected_full_catalog_metrics_are_the_jax_scripts():
    """EXPECTED_FULL_CATALOG_METRICS are what the committed
    port_tools/jax_full_catalog_metrics.py prints from the JAX package."""
    sys.path.insert(0, os.path.join(REPO, "port_tools"))
    from jax_full_catalog_metrics import CHECKPOINTS, full_catalog_metrics

    assert {name: path for name, (_, path) in chip_smoke.SERVING_FAMILY.items()} == {
        name: os.path.join(REPO, path) for name, path in CHECKPOINTS.items()}
    got = full_catalog_metrics()
    want = chip_smoke.EXPECTED_FULL_CATALOG_METRICS
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name])
        for evaluator, metrics in want[name].items():
            assert set(got[name][evaluator]) == set(metrics)
            for key, value in metrics.items():
                assert got[name][evaluator][key] == pytest.approx(value, rel=0, abs=1e-12), (name, evaluator, key)


def test_eval_relevance_holds_the_test_positives():
    data = chip_smoke.mf_split()
    users, rel = chip_smoke.eval_relevance(data)
    assert len(users) == rel.nnz == 943 and (rel.data == 1).all()
    assert np.array_equal(np.unique(rel.nonzero()[0]), users)


def test_phase_34_runs_its_checks_on_the_cpu(tmp_path, monkeypatch):
    """The serving surface on the CPU against itself: every route, the
    evaluators against the JAX metrics (the constants above), the export,
    use_best both ways and the per-user file; no kernel counted."""
    logged = []
    monkeypatch.setattr(chip_smoke, "log", lambda phase, msg: logged.append((phase, msg)))
    counts = chip_smoke.serving_surface(str(tmp_path), device="cpu")
    assert not any(counts.values())
    text = "\n".join(f"{phase}: {msg}" for phase, msg in logged)
    for want in ("MF: recommend(k=10) over 943 users: streaming exact float32", "fast approx bfloat16",
                 "SASRec: recommend(k=10) over 943 users: score_all", "TopKRetrievalEvaluator (streaming route)",
                 "LightGCN: export_embeddings() (943, 64) + (1682, 64) round-trips", "use_best True, False, True",
                 "save_mode per_user: 95243 rows"):
        assert want in text, want


def test_phase_35_runs_its_checks_on_the_cpu_at_a_narrow_size():
    out = chip_smoke.retrieval_at_scale(0, device="cpu", n_users=512, n_items=3000, cpu_users=64, item_block=700)
    assert out["recall"] >= chip_smoke.RECALL_TARGET
    assert {"exact float32", "approx bfloat16", "streaming block 700"} <= set(out)


def test_total_order_ids_rank_negative_zero_below_zero_and_ties_by_id():
    x = torch.tensor([[-0.0, 0.0, 1.0, 1.0, chip_smoke.NEG_INF]])
    assert chip_smoke.total_order_ids(x, 5).tolist() == [[2, 3, 1, 0, 4]]
    assert chip_smoke.total_order_ids(x.bfloat16(), 2).tolist() == [[2, 3]]


def test_ties_on_device_holds_every_case_and_fails_a_wrong_order(monkeypatch):
    assert chip_smoke.ties_on_device("p", "cpu") == 8
    def highest_id_first(x, k):
        values, idx = torch.sort(torch.flip(x.float(), [1]), dim=1, descending=True, stable=True)
        return values[:, :k], x.shape[1] - 1 - idx[:, :k]

    monkeypatch.setattr(chip_smoke, "topk_lowest_index", highest_id_first)
    with pytest.raises(SystemExit):
        chip_smoke.ties_on_device("p", "cpu")


def test_bf16_ties_exact_fails_ids_that_are_not_the_sorts():
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.normal(0, 0.1, (32, 8)).astype(np.float32))
    items = torch.from_numpy(rng.normal(0, 0.1, (500, 8)).astype(np.float32))
    excl = rng.integers(0, 500, (32, 4)).astype(np.int32)
    approx = chip_smoke.retrieval_topk(u, items, 5, exclude_list=torch.as_tensor(excl), mode="approx",
                                       score_dtype="bfloat16")[1].numpy()
    assert chip_smoke.bf16_ties_exact("p", u, items, excl, approx, 5, 16) >= 0
    approx[3, [0, 1]] = approx[3, [1, 0]]
    with pytest.raises(SystemExit):
        chip_smoke.bf16_ties_exact("p", u, items, excl, approx, 5, 16)


def test_same_ids_allows_ties_only():
    scores = np.array([[3.0, 2.0, 2.0, 1.0]])
    lookup = lambda rows, cols: np.take_along_axis(scores[rows], cols, axis=1)  # noqa: E731
    assert chip_smoke.same_ids("p", "w", np.array([[0, 2]]), np.array([[0, 1]]), lookup) == 1
    with pytest.raises(SystemExit):
        chip_smoke.same_ids("p", "w", np.array([[0, 3]]), np.array([[0, 1]]), lookup)


def test_retrieval_bound_at_the_bench_shape():
    """The score matrix's bytes bind both types at 10,240 x 162,000 x 66."""
    ms, by = chip_smoke.retrieval_bound_ms(10_240, 162_000, 66, torch.float32)
    assert by == "bytes" and ms == pytest.approx(2 * 10_240 * 162_000 * 4 / 3.35e12 * 1e3)
    ms, by = chip_smoke.retrieval_bound_ms(10_240, 162_000, 66, torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(2 * 10_240 * 162_000 * 2 / 3.35e12 * 1e3)
    ms, by = chip_smoke.retrieval_bound_ms(64, 100, 4096, torch.float32)
    assert by == "operations"


def test_phase_36_runs_its_checks_on_the_cpu(tmp_path, monkeypatch):
    """One epoch, resumed for one more, against two straight, for lazy Adam
    and the dense trainer, and the JAX last/ resumed; one thread, so the
    CPU's sums repeat."""
    logged = []
    monkeypatch.setattr(chip_smoke, "log", lambda phase, msg: logged.append(msg))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        counts = chip_smoke.resume_phase(0, str(tmp_path), device="cpu", epochs=1)
    finally:
        torch.set_num_threads(threads)
    assert set(counts) == {"resume-mf-sparse", "resume-mf-dense", "resume-jax-last"} and not any(
        any(c.values()) for c in counts.values())
    text = "\n".join(logged)
    assert "lazy Adam: 1 epochs, then resume_training" in text and "dense Adam: 1 epochs" in text
    assert "one epoch (34) trained, then the early stop" in text


def test_phase_38_flash_dtypes_see_bf16_alone(monkeypatch):
    """FlashDtypes records the dtype each flash wrapper is called with (the
    plain path on the CPU goes through the same wrappers); the loss and
    backward of a SASRec whose model section sets compute_dtype bfloat16
    (phase 38's) call both in bfloat16 alone; an engine-level cast alone
    leaves the attention in float32 (the float32 sqrt(d) promotes the rows,
    as in the JAX model), which fails ``only_bf16``; the wrappers are
    restored after the block."""
    from beta_recsys_tpu_torch.core.mixed_precision import loss_with_dtype
    from beta_recsys_tpu_torch.models.sasrec import SASRec as SASRecModel
    from beta_recsys_tpu_torch.ops.kernels import flash_attention

    real = flash_attention.flash_causal_attention
    cfg = {"emb_dim": 16, "num_blocks": 1, "num_heads": 1, "maxlen": 6, "dropout_rate": 0.0}
    seq = torch.tensor([[0, 1, 2, 3, 4, 5], [0, 0, 7, 8, 2, 1]])
    batch = {"seq": seq, "pos": torch.roll(seq, -1, 1), "neg": torch.ones_like(seq)}
    for model_dtype, ok in (("bfloat16", True), (None, False)):
        model = SASRecModel({**cfg, "compute_dtype": model_dtype}, 5, 9, device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        with chip_smoke.FlashDtypes() as dtypes:
            loss_with_dtype(model, "bfloat16")(batch).backward()
        assert flash_attention.flash_causal_attention is real
        kernels = ("flash_causal_attention", "flash_causal_attention_bwd")
        if ok:
            assert set(dtypes.seen) == {(k, "bfloat16") for k in kernels}
            chip_smoke.only_bf16("t", dtypes.seen, kernels)
        else:
            with pytest.raises(SystemExit):
                chip_smoke.only_bf16("t", dtypes.seen, kernels)


def test_phase_38_pipeline_and_run_layer_on_the_cpu(tmp_path, monkeypatch, none_is_the_cpu):
    """The committed structured split regenerated by the port, the
    train_model CLI in a subprocess and mf_default.json's two-trial grid,
    all on the CPU; no kernel counted. One thread here and in the CLI's
    process: beside a parallel test run's workers, more threads only spin."""
    logged = []
    monkeypatch.setattr(chip_smoke, "log", lambda phase, msg: logged.append((phase, msg)))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        counts = chip_smoke.pipeline_and_run_layer(0, str(tmp_path), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert set(counts) == {"tune"} and not any(counts["tune"].values())
    text = "\n".join(f"{phase}: {msg}" for phase, msg in logged)
    for want in ("pipeline: host library build/torch_host/libbetarec_host_", "regenerated equal to the committed",
                 "cli: python -m beta_recsys_tpu_torch.cli.train_model --model mf --max_epoch 1 --device cpu: exit 0",
                 "tune: model.tune over", "bce valid ndcg@10", "bpr valid ndcg@10"):
        assert want in text, want


def test_phase_38_band_is_the_jax_bf16_band():
    band = chip_smoke.MF_BF16_BAND
    assert chip_smoke.MF_BF16_EPOCHS == 5 and all(band[key][1] > 0 for key in ("valid", "test"))
    assert band["valid"][0] - 3 * band["valid"][1] > chip_smoke.UNTRAINED_NDCG  # it can fail an untrained model


SMALL_RAW_SHAPES = {
    "ml_100k": {"n_users": 60, "n_items": 150, "n_ratings": 3000, "min_per_user": 20},
    "dunnhumby": {"n_households": 60, "n_products": 400, "baskets": (4, 10), "basket_size": (1, 8)},
    "tafeng": {"n_users": 80, "n_products": 300, "baskets": (2, 8), "basket_size": (1, 8)},
}

_RAW_TWICE = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "pandas", "sklearn", "beta_recsys_tpu"):
    sys.modules[name] = None  # any import of it now raises ImportError
sys.path.insert(0, {repo!r})
import chip_smoke
for name, shape in {shapes!r}.items():
    runs = [chip_smoke.preprocessed(name, 0, f"{root}/{{name}}/{{run}}", shape) for run in ("a", "b")]
    assert runs[0][2] == runs[1][2], name
    print(name, len(runs[0][2]))
"""


def test_phase_39_raw_files_preprocess_to_the_same_bytes_without_pandas(tmp_path):
    """Phase 39's writers and each adapter's preprocess, twice in fresh
    directories from one seed, with pandas, JAX and the JAX package
    blocked: the interaction npz files are byte-equal."""
    script = _RAW_TWICE.format(repo=chip_smoke.REPO, shapes=SMALL_RAW_SHAPES, root=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert [line.split()[0] for line in out.stdout.splitlines()] == list(SMALL_RAW_SHAPES)


def test_phase_39_writes_the_published_shapes(tmp_path):
    """ml-100k's u.data: 943 users, 1,682 items, 100,000 distinct ratings of
    1-5, at least 20 a user; u.item's latin-1 titles; Ta-Feng's ids are
    digit strings; each dataset's config is its shipped one."""
    shape = chip_smoke.ML100K_SHAPE
    assert shape == {"n_users": 943, "n_items": 1682, "n_ratings": 100_000, "min_per_user": 20}
    assert chip_smoke.DUNNHUMBY_SHAPE["n_households"] == 2_500
    assert chip_smoke.write_ml100k_raw(str(tmp_path), 0, **shape) == 100_000
    rows = np.loadtxt(tmp_path / "ml-100k" / "u.data", dtype=np.int64)
    assert rows.shape == (100_000, 4) and len({(u, i) for u, i in rows[:, :2].tolist()}) == 100_000
    assert len(np.unique(rows[:, 0])) == 943 and rows[:, 1].max() <= 1682 and set(rows[:, 2]) == {1, 2, 3, 4, 5}
    assert np.bincount(rows[:, 0])[1:].min() >= 20
    assert "Café" in (tmp_path / "ml-100k" / "u.item").read_text(encoding="latin-1")
    chip_smoke.write_tafeng_raw(str(tmp_path), 0, **SMALL_RAW_SHAPES["tafeng"])
    order, *items, customer, date = (tmp_path / "train.txt").read_text().splitlines()[0].split("\t")
    assert order.isdigit() and customer.isdigit() and all(i.isdigit() for i in items) and date[4] == "-"
    for name, path in chip_smoke.RAW_CONFIGS.items():
        config = chip_smoke.raw_config(name, 0, str(tmp_path), max_epoch=1)
        assert config.dataset["dataset"] == name and config.dataset["n_test"] == 10
        assert config.dataset["data_split"] == chip_smoke.load_config(os.path.join(chip_smoke.REPO, path)).dataset[
            "data_split"]


def test_phase_39_runs_its_checks_on_the_cpu(tmp_path, monkeypatch, none_is_the_cpu):
    """Phase 39 at a small size on the CPU: each split from its raw files,
    the feature vectors, MF on the lazy-Adam trainer (its "xla" rows here,
    no kernel) to test(); an ndcg@10 at or below the floor fails."""
    logged = []
    monkeypatch.setattr(chip_smoke, "log", lambda phase, msg: logged.append((phase, msg)))
    monkeypatch.setattr(chip_smoke, "RANDOM_NDCG", -1.0)
    counts = chip_smoke.raw_adapters_phase(0, str(tmp_path / "a"), device="cpu", shapes=SMALL_RAW_SHAPES, epochs=1)
    assert set(counts) == {"raw-ml_100k-train"} and not any(counts["raw-ml_100k-train"].values())
    text = "\n".join(f"{phase}: {msg}" for phase, msg in logged)
    for want in ("raw-ml_100k: configs/mf_default.json (leave_one_out, 10 copies of 100 negatives)",
                 "raw-dunnhumby: configs/triple2vec_default.json (leave_one_basket",
                 "raw-tafeng: configs/ultragcn_default.json (leave_one_out", "the same bytes",
                 "make_fea_vec: user_feat (60, 32), item_feat (150, 20)", "phase 39 took"):
        assert want in text, want
    monkeypatch.setattr(chip_smoke, "RANDOM_NDCG", 1.0)
    with pytest.raises(SystemExit):
        chip_smoke.raw_adapters_phase(0, str(tmp_path / "b"), device="cpu", shapes=SMALL_RAW_SHAPES, epochs=1)
