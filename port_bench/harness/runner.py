"""One run of one cell: set-up, the measured window, the traced sub-window
(``--trace 1``), the check against the plain reference, the result line.

The driver of the cell's traffic (``drivers/<driver>.py``) defines
``Driver(cell, seed, device, fault=None)`` with:

  setup()         make the inputs and weights from the seed, build the
                  program's objects, drive them through the checked first
                  calls and warm up every shape the window uses
  call()          one call of the window into the program; returns the work
                  units it issued (``info["unit"]``)
  outcome()       (attempted, failed) over the window's calls
  profiled(n)     n calls, each in its own span, inside the profiled window;
                  returns the calls made
  dispatch(n)     host seconds to issue each of n calls, the device drained
                  before each
  release()       free the program's state
  verify()        recompute the checked outputs with the reference:
                  {number: value}, each held to ``limits/<workload>.json``
  info            what the metric readers need: {"unit": ..., shapes, ...}
"""

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from harness.compare import judge
from harness.spec import BENCH_DIR, load_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "beta_recsys_tpu")


def forbidden_loaded():
    """The forbidden top-level packages in ``sys.modules``, by whole name
    (the program's package name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


@dataclass
class Record:
    """What the metric readers read."""

    cell: object
    info: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0
    calls: int = 0
    trace: object = None
    dispatch_s: list = field(default_factory=list)


def process_start(now):
    """``now`` (perf_counter) minus the age of this process, from /proc."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


def card():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed, seconds, trace, device, t_process, fault=None):
    """(result dict, check rows, (seconds to the driver's set-up, seconds in
    it)) of one run of ``cell``; ``device`` "cuda" for a measured run, "cpu"
    only in the benchmark's own tests."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    driver = cell.driver().Driver(cell, seed, device, fault=fault)
    record = Record(cell=cell, info=driver.info)

    t_driver = time.perf_counter()
    driver.setup()
    _sync(torch, device)
    record.setup_s = time.perf_counter() - t_process
    record.info["setup_split_s"] = (t_driver - t_process, time.perf_counter() - t_driver)

    t0 = time.perf_counter()
    while True:
        record.units += driver.call()
        record.calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(torch, device)
    record.window_s = time.perf_counter() - t0
    loaded = forbidden_loaded()
    if loaded:
        raise SystemExit(f"forbidden packages loaded once the window closed: {loaded}")

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from harness.trace import WINDOW, Trace

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        _sync(torch, device)
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                steps = driver.profiled(int(cell.traffic["profile_calls"]))
                _sync(torch, device)
        record.trace = Trace.from_profiler(prof, steps)
        record.dispatch_s = driver.dispatch(int(cell.traffic["profile_calls"]))

    attempted, failed = driver.outcome()
    device_out = {"platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  "count": cell.chips,
                  "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0}
    if record.trace is not None:
        device_out["busy_s"] = record.trace.busy_s
        device_out["window_s"] = record.trace.window_s

    driver.release()
    numbers = driver.verify()
    correct, rows = judge(numbers, cell.limits)

    metrics = {}
    for spec in cell.per_layer if trace else cell.end_to_end:
        value = cell.reader(spec["name"]).read(record)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    result = {"correct": bool(correct and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_out}
    if record.trace is not None and record.trace.device:
        result["breakdown"] = {"device_ops": record.trace.top_ops(), "idle_gaps": record.trace.idle_gaps()}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return result, rows, record.info["setup_split_s"]


def main(argv, t_process):
    parser = argparse.ArgumentParser(description="Run one benchmark cell once on the card.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = BENCH_DIR.parent
    # Kernel and compiler caches at fixed paths inside the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    cell = load_cell(root, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 2
    result, rows, split = run(cell, args.seed, args.seconds, args.trace, "cuda", t_process)
    loaded = forbidden_loaded()
    if loaded:
        print(f"forbidden packages loaded: {loaded}", file=sys.stderr)
        return 3
    print(f"card {card()}", file=sys.stderr)
    print("setup_s: %.3f s to the driver's set-up, %.3f s in it" % split, file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
