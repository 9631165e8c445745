#!/usr/bin/env python3
"""Time the flash-attention backward and the all-gather of one checkout of
the port.

    python3 port_tools/time_kernels.py <checkout root> <label> [flash] [ring] [across]

Needs a GPU. Imports ``beta_recsys_tpu_torch`` from ``<checkout root>``
(building its kernels there, in ``build/torch_kernels/``) and the timers of
this checkout's ``chip_smoke.py``, and prints one JSON line: ``<label>``,
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
  rounding (bit for bit for the all-gather).

Groups (all three when none is named):

- ``flash``: the backward at N 256 x T 100 x dh 32 (rates 0.1 and 0),
  T 200 (rate 0.1), 256 x 100 x 16 and 128 x 100 x 64 (rate 0.1), float32;
- ``ring``: the all-gather at n 4 x (C, 64) float32 for C 200, 800 and 8192,
  every rank on cuda:0;
- ``across``: the same shapes with rank r on cuda:r, and
  ``torch.cuda.nccl.all_gather`` into outputs allocated beforehand; needs 4
  cards and is left out on fewer.

To compare two commits, unpack the parent with ``git archive`` into a
directory ``.gitignore`` lists and run, in one call, parent, change, change,
parent, each in its own process.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(sys.argv[1]))
import beta_recsys_tpu_torch  # noqa: E402,F401  (the checkout's package, before chip_smoke's path)

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from beta_recsys_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    flash_causal_attention,
    flash_causal_attention_bwd,
)
from beta_recsys_tpu_torch.ops.kernels.ring_exchange import ring_allgather  # noqa: E402

FLASH_SHAPES = ((256, 100, 32, 0.1), (256, 100, 32, 0.0), (256, 200, 32, 0.1), (256, 100, 16, 0.1),
                (128, 100, 64, 0.1))
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
    groups = set(sys.argv[3:]) or {"flash", "ring", "across"}
    out = {"label": sys.argv[2], "card": cs.nvidia_smi_line()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "flash" in groups:
        flash_rows(out, gen)
    if "ring" in groups:
        ring_rows(out, gen, ["cuda:0"] * 4, "loopback")
    if "across" in groups and torch.cuda.device_count() >= 4:
        ring_rows(out, gen, [f"cuda:{i}" for i in range(4)], "across")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
