#!/usr/bin/env python3
"""Time the flash-attention forward and backward, ``fused_rowadam``, the
packed row write and the all-gather of one checkout of the port.

    python3 port_tools/time_kernels.py <checkout root> <label> [fwd] [flash] [rowadam] [packed] [ring] [across]

Needs a GPU. Imports ``beta_recsys_tpu_torch`` from ``<checkout root>``
(building its kernels there, in ``build/torch_kernels/``) and the timers of
``chip_smoke.py`` (the checkout's own where it holds one, else this
checkout's), and prints one JSON line: ``<label>``,
the card, and for each shape

- ``device_ms``: the kernels' own time, calls back to back on the device
  (``chip_smoke.queued_ms``: queued behind a sleep kernel on every card, so
  the device never waits for the host);
- ``call_ms``: a call as a caller sees it, the slower of the host's and the
  device's pace: CUDA events around back-to-back calls on one card
  (``chip_smoke.cuda_ms``), the host clock around back-to-back calls between
  synchronised cards across several (``chip_smoke.wall_ms``);
- ``issue_ms`` (across cards): the host's time to issue a call while every
  card sleeps, so that no call waits on a device;
- a checksum of the outputs, which two checkouts must share up to float
  rounding (bit for bit for the all-gather and the packed write).

Groups (``fwd``, ``flash``, ``rowadam``, ``packed``, ``ring`` and ``across``
when none is named):

- ``fwd``: the forward at the serving shapes 1886 x 100 x 32 and
  8192 x 200 x 32 (rate 0) and the training shapes 256 x 100 x 32 (rates
  0.1 and 0), 256 x 200 x 32, 256 x 100 x 16 and 128 x 100 x 64 (rate
  0.1), float32;
- ``flash``: the backward at N 256 x T 100 x dh 32 (rates 0.1 and 0),
  T 200 (rate 0.1), 256 x 100 x 16 and 128 x 100 x 64 (rate 0.1), float32;
- ``rowadam``: one mf-sparse step's row updates (943 x 64 with L 400 and
  1682 x 64 with L 800 uniform ids) and a table-scale update (1,000,000 x
  64, L 16,384 zipf ids), ids deduplicated as the trainer does. A checkout
  with ``RowAdamTables`` makes one grouped call a step through a group
  built beforehand, as its trainer does; an older one calls
  ``fused_rowadam`` once a table;
- ``packed``: ``fused_rowadam_packed`` and ``fused_rowadam_packed_bf16``
  through a ``RowAdamPacked`` built beforehand, as the trainer calls them,
  on ``chip_smoke.packed_inputs`` at MF's step (``PACKED_MF_STEP``: L 1,200
  uniform ids), at table scale (``PACKED_SCALE``: 1,100,000 rows, L 49,152
  zipf ids), at table scale after ``compact_rows`` at
  ``PACKED_SCALE_CAPACITY``, below the step's distinct ids, and at table
  scale with uniform ids (``PACKED_SCALE_UNIFORM``); each with its
  ids, first occurrences and touched rows, its two bounds
  (``chip_smoke.packed_bound``, ``packed_read_bound``) and, after one call on
  a fresh copy, the SHA-256 of the rows at its ids and the sum of the whole
  array's 16-bit words;
- ``epochs`` (only when named): training epochs on the structured split
  through the checkout's trainers, the kernels' end-to-end effect: MF + BPR
  lazy Adam at ``configs/mf_default.json`` with row_update "fused" (6
  epochs of 246 steps) and SASRec at the trained checkpoint's config (20
  epochs of 7 steps); examples/s or sequences/s of each epoch (host clock,
  ending in the epoch's loss read) and ``fused_rowadam`` launches a step;
  and, with no kernel, the dense pairwise trainer (MF as shipped) and the
  pointwise one (NCF as shipped), 6 epochs each, examples or positives/s;
- ``ring``: the all-gather at n 4 x (C, 64) float32 for C 200, 800 and 8192,
  every rank on cuda:0;
- ``across``: the same shapes with rank r on cuda:r, and
  ``torch.cuda.nccl.all_gather`` into outputs allocated beforehand; needs 4
  cards and is left out on fewer.

To compare two commits, unpack the parent with ``git archive`` into a
directory ``.gitignore`` lists and run, in one call, parent, change, change,
parent, each in its own process.
"""

import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(sys.argv[1]))
import beta_recsys_tpu_torch  # noqa: E402,F401  (the checkout's package, before chip_smoke's path)

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from beta_recsys_tpu_torch.core.sparse_optim import _segment_dedup, compact_rows  # noqa: E402
from beta_recsys_tpu_torch.ops.kernels import rowadam  # noqa: E402
from beta_recsys_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    flash_causal_attention,
    flash_causal_attention_bwd,
)
from beta_recsys_tpu_torch.ops.kernels.ring_exchange import ring_allgather  # noqa: E402

FLASH_SHAPES = ((256, 100, 32, 0.1), (256, 100, 32, 0.0), (256, 200, 32, 0.1), (256, 100, 16, 0.1),
                (128, 100, 64, 0.1))
FWD_SHAPES = ((1886, 100, 32, 0.0), (8192, 200, 32, 0.0), *FLASH_SHAPES)
# (name, [(n_rows, L, d, zipf)] a call): the tables one call updates.
ROWADAM_CASES = (("mf-step", [(943, 400, 64, False), (1682, 800, 64, False)]),
                 ("table-scale", [(1_000_000, 16_384, 64, True)]))
RING_CS = (200, 800, 8192)


def issue_ms(fn, devices, reps=20, sleep_cycles=40_000_000):
    """Mean host milliseconds to issue one call of ``fn`` while a sleep
    kernel holds every card of ``devices``."""
    fn()
    cs.sync_all(devices)
    for device in dict.fromkeys(torch.device(d) for d in devices):
        with torch.cuda.device(device):
            torch.cuda._sleep(sleep_cycles)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    cs.sync_all(devices)
    return host


def flash_rows(out, gen):
    for n, t, dh, rate in FLASH_SHAPES:
        q, k, v, do = (torch.randn(n, t, dh, generator=gen, device="cuda") for _ in range(4))
        seed = torch.tensor([12345], device="cuda")
        _, lse = flash_causal_attention(q, k, v, rate, seed)
        grads = flash_causal_attention_bwd(q, k, v, lse, do, rate, seed)

        def call():
            return flash_causal_attention_bwd(q, k, v, lse, do, rate, seed)

        out[f"flash_bwd {n}x{t}x{dh} rate {rate}"] = {
            "device_ms": cs.queued_ms(call), "call_ms": cs.cuda_ms(call),
            "checksum": [float(g.double().abs().sum()) for g in grads]}


def fwd_rows(out, gen):
    for n, t, dh, rate in FWD_SHAPES:
        q, k, v = (torch.randn(n, t, dh, generator=gen, device="cuda") for _ in range(3))
        seed = torch.tensor([12345], device="cuda")

        def call():
            return flash_causal_attention(q, k, v, rate, seed)

        res = call()
        out[f"flash_fwd {n}x{t}x{dh} rate {rate}"] = {
            "device_ms": cs.queued_ms(call), "call_ms": cs.cuda_ms(call),
            "checksum": [float(x.double().abs().sum()) for x in res]}


def rowadam_rows(out):
    """Device and call time of one call's row updates, and a checksum of the
    tables after one call on fresh copies."""
    bc, lr = rowadam.bias_corrections(3), 0.05
    for name, shapes in ROWADAM_CASES:
        tables, ids, grads = [], [], []
        for i, (n_rows, n_ids, d, zipf) in enumerate(shapes):
            table, m, v, idx, g = cs.rowadam_inputs(n_rows, n_ids, d, i, "cuda", zipf)
            ids_s, g_d = _segment_dedup(idx, g)
            tables.append((table, m, v))
            ids.append(ids_s)
            grads.append(g_d)
        fresh = [tuple(x.clone() for x in t) for t in tables]
        if hasattr(rowadam, "RowAdamTables"):
            group = rowadam.RowAdamTables(tables)
            check = rowadam.RowAdamTables(fresh)

            def call():
                group(ids, grads, bc, lr)

            def once():
                check(ids, grads, bc, lr)
        else:
            def call():
                for t, i, g in zip(tables, ids, grads):
                    rowadam.fused_rowadam(*t, i, g, bc, lr)

            def once():
                for t, i, g in zip(fresh, ids, grads):
                    rowadam.fused_rowadam(*t, i, g, bc, lr)

        launches = rowadam.fused_rowadam.launches
        once()
        out[f"rowadam {name}"] = {
            "launches": rowadam.fused_rowadam.launches - launches,
            "device_ms": cs.queued_ms(call), "call_ms": cs.cuda_ms(call),
            "checksum": [float(x.double().abs().sum()) for t in fresh for x in t]}


# (name, shape, seed, capacity): phase 40's inputs (chip_smoke.row_layouts_phase, seed 0).
PACKED_CASES = (("mf-step", cs.PACKED_MF_STEP, 0, None), ("table-scale", cs.PACKED_SCALE, 1, None),
                ("table-scale compact", cs.PACKED_SCALE, 1, cs.PACKED_SCALE_CAPACITY),
                ("table-scale uniform", cs.PACKED_SCALE_UNIFORM, 1, None))


def packed_rows(out):
    """Device and call time of one packed write through a prebuilt
    ``RowAdamPacked``, its bounds and the hash of one call's result."""
    denoms, lr = rowadam.bias_denominators(3), 0.05
    for bf16 in (False, True):
        name = "fused_rowadam_packed_bf16" if bf16 else "fused_rowadam_packed"
        counter = getattr(rowadam, name)
        for case, shape, seed, capacity in PACKED_CASES:
            layout, packed, ids, grads = cs.packed_inputs(**shape, seed=seed, bf16=bf16)
            if capacity is not None:
                grads, _ = compact_rows(ids, grads, capacity)
            touched = int(rowadam.packed_touched(layout.rects, ids, grads).any(dim=1).sum())
            first, n_ids = cs.first_occurrences(ids), int(ids.shape[0])
            fresh = packed.clone()
            launches = counter.launches
            rowadam.RowAdamPacked(fresh, layout.rects, bf16=bf16)(ids, grads, denoms, lr)
            torch.cuda.synchronize()
            group = rowadam.RowAdamPacked(packed, layout.rects, bf16=bf16)

            def call():
                group(ids, grads, denoms, lr)

            bound, _ = cs.packed_bound(touched, layout.w, n_ids, bf16)
            out[f"{name} {case}"] = {
                "n_ids": n_ids, "first_rows": first, "touched_rows": touched, "launches": counter.launches - launches,
                "device_ms": cs.queued_ms(call), "call_ms": cs.cuda_ms(call), "bound_ms": bound,
                "read_bound_ms": cs.packed_read_bound(first, touched, layout.w, n_ids, bf16),
                "checksum": [hashlib.sha256(fresh[ids.unique()].cpu().numpy().tobytes()).hexdigest(),
                             int(fresh.view(torch.int16).long().sum())]}
            del layout, packed, fresh, group
            torch.cuda.empty_cache()


def epoch_rows(out):
    """Per-epoch rates of MF lazy-Adam and SASRec training (see the module
    docstring)."""
    import tempfile

    from beta_recsys_tpu_torch.core.train_engine import TrainEngine
    from beta_recsys_tpu_torch.data.sequential_data import SequentialData
    try:
        from beta_recsys_tpu_torch.datasets.data_split import load_split_data
    except ImportError:  # a checkout from before the port had its own split pipeline
        from beta_recsys_tpu_torch.datasets.split_io import load_split_data
    from beta_recsys_tpu_torch.models import build_model

    def rates(cfg, data, epochs, per_epoch):
        model = build_model(cfg.model, data.n_users, data.n_items, device="cuda")
        engine = TrainEngine(cfg, torch.device("cuda")).build(model, data)
        fn, got = engine.epoch_fn, []
        for _ in range(epochs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(fn.run(engine.generator))
            got.append(per_epoch(fn) / (time.perf_counter() - t0))
        return got, fn.num_batches

    with tempfile.TemporaryDirectory() as root:
        launches = rowadam.fused_rowadam.launches
        mf, steps = rates(cs.mf_config(0, root, sparse_optim=True, row_update="fused"), cs.mf_split(), 6,
                          lambda fn: fn.padded_size)
        out["mf-sparse epochs"] = {"examples_per_s": mf,
                                   "fused_rowadam_launches_per_step": (rowadam.fused_rowadam.launches - launches)
                                   / (6 * steps)}
        seq = SequentialData(load_split_data(cs.SPLIT, n_test=1))
        sas, _ = rates(cs.sasrec_config(0, root), seq, 20, lambda fn: fn.num_batches * fn.batch_size)
        out["sasrec-train epochs"] = {"sequences_per_s": sas}
        dense, _ = rates(cs.mf_config(0, root), cs.mf_split(), 6, lambda fn: fn.padded_size)
        out["mf-dense epochs"] = {"examples_per_s": dense}
        ncf, _ = rates(cs.ncf_config("NCF", 0, root), cs.mf_split(), 6, lambda fn: fn.padded_size)
        out["ncf-train epochs"] = {"positives_per_s": ncf}


def ring_rows(out, gen, devices, key):
    for c in RING_CS:
        blocks = [torch.randn(c, 64, generator=gen, device="cuda").to(d) for d in devices]

        def call():
            return ring_allgather(blocks)

        row = {"device_ms": cs.queued_ms(call, devices),
               "checksum": [float(o.double().sum()) for o in call()]}
        if len(set(devices)) > 1:
            row["call_ms"] = cs.wall_ms(call, devices)
            row["issue_ms"] = issue_ms(call, devices)
            outs = [torch.empty((len(devices), c, 64), device=d) for d in devices]

            def nccl():
                return torch.cuda.nccl.all_gather(blocks, outs)

            row["nccl_call_ms"] = cs.wall_ms(nccl, devices)
            row["nccl_device_ms"] = cs.queued_ms(nccl, devices)
        else:
            row["call_ms"] = cs.cuda_ms(call)
        out[f"ring {key} 4x({c}, 64)"] = row


def main():
    groups = set(sys.argv[3:]) or {"fwd", "flash", "rowadam", "packed", "ring", "across"}
    out = {"label": sys.argv[2], "card": cs.nvidia_smi_line()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "fwd" in groups:
        fwd_rows(out, gen)
    if "flash" in groups:
        flash_rows(out, gen)
    if "rowadam" in groups:
        rowadam_rows(out)
    if "packed" in groups:
        packed_rows(out)
    if "epochs" in set(sys.argv[3:]):
        epoch_rows(out)
    if "ring" in groups:
        ring_rows(out, gen, ["cuda:0"] * 4, "loopback")
    if "across" in groups and torch.cuda.device_count() >= 4:
        ring_rows(out, gen, [f"cuda:{i}" for i in range(4)], "across")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
