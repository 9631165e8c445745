#!/usr/bin/env python3
"""Drive the PyTorch port (beta_recsys_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printed with the seconds elapsed:
  0. environment: the card (nvidia-smi), torch and CUDA versions, TF32 flags;
  1. build the port's CUDA kernel from csrc/ (one nvcc call);
  2. each kernel against its plain PyTorch version on the card, at the shapes
     the serving path gives it, with times (kernel, plain, one library call as
     a yardstick) and the least time the card could take;
  3. serve the trained SASRec checkpoint in parity_runs/: load -> test() ->
     predict() -> recommend(); the test metrics must reproduce the JAX
     package's to 1e-4 and the top-10 lists must match the plain path;
  4. serve configs/sasrec_default.json (maxlen 200) with weights from the
     port's initializer over synthetic data shaped like MovieLens-1M;
  5. a JSON line of every kernel with its launches on each serving path,
     counted from 0 around that path's own calls.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before it. Imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from beta_recsys_tpu_torch.config import load_config  # noqa: E402
from beta_recsys_tpu_torch.data.sequential_data import SequentialData  # noqa: E402
from beta_recsys_tpu_torch.datasets.split_io import load_split_data  # noqa: E402
from beta_recsys_tpu_torch.device import fp32_matmuls  # noqa: E402
from beta_recsys_tpu_torch.ops.kernels import _build  # noqa: E402
from beta_recsys_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    flash_causal_attention,
    flash_causal_attention_reference,
)
from beta_recsys_tpu_torch.recommenders import SASRec  # noqa: E402
from beta_recsys_tpu_torch.utils.constants import (  # noqa: E402
    DEFAULT_ITEM_COL,
    DEFAULT_PREDICTION_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)

CHECKPOINT = os.path.join(REPO, "parity_runs/checkpoints/SASRec_default_20260821_081415_yybcvt")
SPLIT = os.path.join(
    REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100"
)
DEFAULT_CONFIG = os.path.join(REPO, "configs/sasrec_default.json")

# The JAX package's SASRec(...).load(CHECKPOINT, data).test() on this split.
EXPECTED_METRICS = {
    "ndcg@10": 0.186726, "recall@10": 0.458112, "precision@10": 0.045811, "map@10": 0.106825,
}
METRIC_TOL = 1e-4  # the expected values are given to 6 decimals
# Kernel against plain version, same inputs on the card. float32: the two sum
# in other orders and the kernel exponentiates in base 2, a few ulp apart.
# bfloat16: both compute in float32 and round the output once to bfloat16, so
# they may land one bfloat16 step apart (2^-7 relative): |d| <= 2e-2 * max(1, |plain|).
# lse stays float32 on both sides whatever the input type: the float32 limit.
TOL = {torch.float32: {"out": 1e-4, "lse": 1e-5}, torch.bfloat16: {"out": 2e-2, "lse": 1e-5}}
NEAR_TIE = 1e-5  # top-10 lists may differ only where plain scores are this close
USER_BLOCK = 4096  # users per scoring call in the default config's recommend()
# H100 SXM peaks (NVIDIA data sheet): bytes/s of HBM3, FLOP/s by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

T0 = time.perf_counter()


def log(phase, msg):
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card (CUDA events around ``reps``
    back-to-back calls, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_breakdown(fn, top=5):
    """One profiled call of ``fn``: its wall time, the device's busy share of
    it (device time of kernels and copies over wall time) and the ``top``
    device activities by time. The profiler adds host overhead to the wall
    time, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = sorted(
        ((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    if not on_device:
        return f"profiled wall {wall_us / 1e3:.2f} ms; device time not measured (no CUDA events)"
    busy_us = sum(t for t, _, _ in on_device)
    tops = "; ".join(f"{key[:60]} x{count} {t / 1e3:.3f} ms" for t, key, count in on_device[:top])
    return (f"profiled wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.3f} ms "
            f"({100 * busy_us / wall_us:.1f}%, idle {100 - 100 * busy_us / wall_us:.1f}%); top: {tops}")


def attention_bound(n, t, dh, dtype):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (q, k, v read once, out and lse written once) over the HBM rate and the
    FLOPs of the visible (query, key) pairs (4 * dh each) over the peak rate
    of the input type."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = n * t * (4 * dh * itemsize + 4)
    flops = 4 * dh * n * t * (t + 1) // 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def compare_flash(n, t, dh, dtype, gen, timed):
    """Kernel vs plain version on one random (n, t, dh) input; returns a row."""
    q, k, v = (torch.randn(n, t, dh, generator=gen, device="cuda").to(dtype) for _ in range(3))
    out, lse = flash_causal_attention(q, k, v)
    ref_out, ref_lse = flash_causal_attention_reference(q, k, v)
    torch.cuda.synchronize()
    d_out = (out.float() - ref_out.float()).abs()
    d_lse = (lse - ref_lse).abs()
    tol = TOL[dtype]
    if dtype == torch.bfloat16:
        ok_out = bool((d_out <= tol["out"] * ref_out.float().abs().clamp(min=1.0)).all())
    else:
        ok_out = bool((d_out <= tol["out"]).all())
    row = {
        "shape": [n, t, dh], "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": float(d_out.max()), "lse_max_abs_err": float(d_lse.max()),
    }
    if not ok_out or row["lse_max_abs_err"] > tol["lse"] or not torch.isfinite(out.float()).all():
        fail(f"flash kernel disagrees with its plain version: {row}, tolerances {tol}")
    if timed:
        row["ms"] = cuda_ms(lambda: flash_causal_attention(q, k, v))
        row["plain_ms"] = cuda_ms(lambda: flash_causal_attention_reference(q, k, v))
        row["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
        )
        row["bound_ms"], row["bound_by"] = attention_bound(n, t, dh, dtype)
        log("flash", f"{n}x{t}x{dh} {row['dtype']}: kernel {row['ms'] * 1e3:.1f} us, plain "
            f"{row['plain_ms'] * 1e3:.1f} us, library {row['library_ms'] * 1e3:.1f} us, bound "
            f"{row['bound_ms'] * 1e3:.1f} us by {row['bound_by']} "
            f"({100 * row['bound_ms'] / row['ms']:.1f}% of bound)")
    return row


def ml1m_shaped_split(seed, n_users=6040, n_items=3706, n_interactions=1_000_209,
                      max_per_user=2314, n_negative=100):
    """A leave-one-out split shaped like MovieLens-1M, made with numpy.

    Every user has 20 to ``max_per_user`` interactions (MovieLens-1M's least
    and most), a long-tailed count; items
    are drawn without repetition per user, biased toward popular ones; the
    newest interaction of each user is the test positive, the one before it
    the validation positive, each beside ``n_negative`` sampled items the
    user never interacted with. Returns (train, [valid], [test]) frames.
    """
    rng = np.random.default_rng(seed)
    weights = rng.lognormal(0.0, 1.2, n_users)
    extra = np.floor(weights / weights.sum() * (n_interactions - 20 * n_users)).astype(np.int64)
    counts = np.minimum(20 + extra, max_per_user)
    while (short := n_interactions - counts.sum()) > 0:
        np.add.at(counts, rng.choice(np.nonzero(counts < max_per_user)[0], short), 1)
        counts = np.minimum(counts, max_per_user)
    # Gumbel top-k: per user, items in order of log(popularity) + Gumbel noise
    # is a draw without replacement weighted by popularity.
    log_pop = -0.8 * np.log(np.arange(n_items) + 10.0)
    users, items = [], []
    for lo in range(0, n_users, 512):
        hi = min(lo + 512, n_users)
        keys = log_pop[None, :] + rng.gumbel(size=(hi - lo, n_items))
        order = np.argsort(-keys, axis=1)
        take = np.arange(n_items)[None, :] < counts[lo:hi, None]
        users.append(np.broadcast_to(np.arange(lo, hi)[:, None], take.shape)[take])
        items.append(order[take])
    users, items = np.concatenate(users), np.concatenate(items)
    stamps = rng.integers(956_703_932, 1_046_454_590, size=len(users))
    order = np.lexsort((stamps, users))
    users, items, stamps = users[order], items[order], stamps[order]
    from_end = np.repeat(np.cumsum(counts), counts) - np.arange(len(users))  # 1 = newest

    def frame(sel, ratings=None):
        return {
            DEFAULT_USER_COL: users[sel] + 1, DEFAULT_ITEM_COL: items[sel] + 1,
            DEFAULT_RATING_COL: np.ones(int(sel.sum()), np.float32),
            DEFAULT_TIMESTAMP_COL: stamps[sel],
        }

    seen = np.zeros((n_users, n_items), dtype=bool)
    seen[users, items] = True

    def with_negatives(pos):
        neg_u = np.repeat(np.arange(n_users), n_negative)
        neg_i = rng.integers(0, n_items, size=len(neg_u))
        while True:
            bad = seen[neg_u, neg_i]
            if not bad.any():
                break
            neg_i[bad] = rng.integers(0, n_items, size=int(bad.sum()))
        return {
            DEFAULT_USER_COL: np.concatenate([pos[DEFAULT_USER_COL], neg_u + 1]),
            DEFAULT_ITEM_COL: np.concatenate([pos[DEFAULT_ITEM_COL], neg_i + 1]),
            DEFAULT_RATING_COL: np.concatenate(
                [pos[DEFAULT_RATING_COL], np.zeros(len(neg_u), np.float32)]
            ),
            DEFAULT_TIMESTAMP_COL: np.concatenate(
                [pos[DEFAULT_TIMESTAMP_COL], np.zeros(len(neg_u), np.int64)]
            ),
        }

    train = frame(from_end > 2)
    valid = with_negatives(frame(from_end == 2))
    test = with_negatives(frame(from_end == 1))
    return train, [valid], [test]


def check_recommendations(rec, data, k, n_users):
    items = rec[DEFAULT_ITEM_COL].reshape(n_users, k)
    scores = rec[DEFAULT_PREDICTION_COL].reshape(n_users, k)
    if not np.isfinite(scores).all():
        fail("recommend() returned non-finite scores")
    if (np.diff(scores, axis=1) > 0).any():
        fail("recommend() rows are not in descending score order")
    train = data.user_item_csr()
    users = rec[DEFAULT_USER_COL].reshape(n_users, k)[:, 0]
    hit = np.asarray(train[np.repeat(users, k), items.reshape(-1)]).reshape(-1) > 0
    if hit.any():
        fail(f"recommend() returned {int(hit.sum())} train items")


def same_top_k(rec, ref, k):
    """Top-k lists of the kernel path and of the plain path agree: scores at
    each rank to 1e-4, and where the items at a rank differ, their scores lie
    within NEAR_TIE (the two items tie up to float32 rounding). Returns the
    number of rows that differ."""
    a = rec[DEFAULT_ITEM_COL].reshape(-1, k)
    b = ref[DEFAULT_ITEM_COL].reshape(-1, k)
    gap = np.abs(rec[DEFAULT_PREDICTION_COL] - ref[DEFAULT_PREDICTION_COL]).reshape(-1, k)
    if gap.max() > 1e-4:
        fail(f"top-{k} scores differ from the plain path by {gap.max()}")
    swapped = (a != b) & (gap > NEAR_TIE)
    if swapped.any():
        u = int(np.nonzero(swapped.any(axis=1))[0][0])
        fail(f"top-{k} of row {u} differs beyond near-ties: {a[u]} vs {b[u]}")
    return int((a != b).any(axis=1).sum())


def check_launches(path, launches, expected):
    """The kernel ran on ``path``: once per attention block per scoring call."""
    if launches != expected or launches == 0:
        fail(f"flash kernel launched {launches} times on the {path} path, expected {expected}")
    log(path, f"flash kernel launches on the path: {launches} (= {expected} expected)")


def serve_checkpoint(root_dir):
    """Phase 3. Returns the flash kernel's launches in the path's counted
    calls: load, test() twice, predict(), recommend() twice."""
    data = SequentialData(load_split_data(SPLIT, n_test=1))
    cfg = load_config(CHECKPOINT).replace(system={"root_dir": root_dir})
    log("serve", f"split: {data.n_users} users, {data.n_items} items, "
        f"{len(data.train[DEFAULT_USER_COL])} train rows")

    flash_causal_attention.launches = 0
    rec = SASRec(cfg).load(CHECKPOINT, data)
    res = rec.test()
    torch.cuda.synchronize()
    for key, want in EXPECTED_METRICS.items():
        if abs(res[key] - want) > METRIC_TOL:
            fail(f"test() {key} = {res[key]:.6f}, expected {want} +- {METRIC_TOL}")
    log("serve", "test() " + ", ".join(f"{k} {res[k]:.6f}" for k in EXPECTED_METRICS)
        + f" (expected to {METRIC_TOL})")
    t0 = time.perf_counter()
    rec.test()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0

    pairs = {c: data.test[0][c][:300] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    scores = rec.predict(pairs)
    if scores.shape != (300,) or not np.isfinite(scores).all():
        fail(f"predict() gave {scores.shape} with non-finite values")

    k = 10
    recs = rec.recommend(k=k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = rec.recommend(k=k)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    check_recommendations(recs, data, k, data.n_users)
    launches = flash_causal_attention.launches
    calls = 2 * len(data.test) + 1 + 2  # test() twice, predict(), recommend() twice
    check_launches("checkpoint", launches, rec.model.num_blocks * calls)

    plain = SASRec(cfg.replace(model={"fused_attention": False})).load(CHECKPOINT, data)
    ref_scores = plain.predict(pairs)
    err = float(np.abs(scores - ref_scores).max())
    if err > 1e-4:
        fail(f"predict() differs from the plain path by {err}")
    differ = same_top_k(recs, plain.recommend(k=k), k)
    log("serve", f"predict(300 pairs) max |d| vs plain {err:.3g}; recommend(k={k}) "
        f"{data.n_users} users, no train item, {differ} rows differ from plain at near-ties")
    n_eval = len(data.eval_candidates(data.test[0]).users)
    log("serve", f"test() {n_eval / test_s:.1f} users/s "
        f"({test_s * 1e3:.2f} ms); recommend() {data.n_users / rec_s:.1f} users/s "
        f"({rec_s * 1e3:.2f} ms)")
    log("serve", "test(): " + device_breakdown(rec.test))
    log("serve", "recommend(): " + device_breakdown(lambda: rec.recommend(k=k)))
    return launches


def serve_default_config(seed, root_dir):
    """Phase 4: configs/sasrec_default.json, random weights, ML-1M shape.
    Returns the flash kernel's launches in the timed recommend()."""
    t0 = time.perf_counter()
    data = SequentialData(ml1m_shaped_split(seed))
    log("default", f"synthetic split: {data.n_users} users, {data.n_items} items, "
        f"{len(data.train[DEFAULT_USER_COL])} train rows ({time.perf_counter() - t0:.2f} s)")
    cfg = load_config(DEFAULT_CONFIG).replace(system={"root_dir": root_dir})
    gen = torch.Generator().manual_seed(seed)
    rec = SASRec(cfg).init(data, gen)
    k = 10
    rec.recommend(users=np.arange(512), k=k, user_block=USER_BLOCK)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_causal_attention.launches = 0
    t0 = time.perf_counter()
    recs = rec.recommend(k=k, user_block=USER_BLOCK)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    launches = flash_causal_attention.launches
    n_calls = -(-data.n_users // USER_BLOCK)  # one scoring call per block of users
    check_launches("default", launches, rec.model.num_blocks * n_calls)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_recommendations(recs, data, k, data.n_users)
    plain = SASRec(cfg.replace(model={"fused_attention": False}))
    plain.init(data, torch.Generator().manual_seed(seed))
    users = np.arange(256)
    differ = same_top_k(rec.recommend(users=users, k=k), plain.recommend(users=users, k=k), k)
    log("default", f"recommend(k={k}) {data.n_users} users, maxlen {rec.model.maxlen}: "
        f"{data.n_users / rec_s:.1f} users/s ({rec_s * 1e3:.2f} ms), peak memory "
        f"{peak_gib:.3f} GiB; first 256 users vs plain: {differ} rows differ at near-ties")
    log("default", "recommend(): " + device_breakdown(lambda: rec.recommend(k=k, user_block=USER_BLOCK)))
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")

    smi = nvidia_smi_line()
    print(smi, flush=True)
    fp32_matmuls()
    log("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    lib, secs, report = _build.build("flash_attention_fwd")
    log("build", f"flash_attention_fwd: {os.path.relpath(lib, REPO)} in {secs:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log("build", "  " + line.strip())

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n in (2, 1886):
            for t in (1, 77, 100, 200):
                timed = (n, t) == (1886, 100)
                row = compare_flash(n, t, 32, dtype, gen, timed)
                rows[(n, t, dtype)] = row
                log("flash", json.dumps(row))
        # The default config's recommend() blocks: 4096 users x 2 heads, maxlen 200.
        row = compare_flash(8192, 200, 32, dtype, gen, timed=True)
        rows[(8192, 200, dtype)] = row
        log("flash", json.dumps(row))

    with tempfile.TemporaryDirectory() as root_dir:
        launches = {
            "checkpoint": serve_checkpoint(root_dir),
            "default": serve_default_config(args.seed, root_dir),
        }

    main_row = rows[(1886, 100, torch.float32)]
    kernels = [{
        "name": "flash_causal_attention_fwd",
        "route": "cuda",
        "source": "beta_recsys_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "beta_recsys_tpu/ops/pallas/flash_attention.py:57",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for key, r in rows.items() if key[2] == torch.float32),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "dtype": main_row["dtype"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
