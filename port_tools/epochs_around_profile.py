#!/usr/bin/env python3
"""Epoch times of MF (dense trainer) and LightGCN in one process, before and
after one profiled window of 10 MF steps: does a torch.profiler session
leave the process's later steps slower?

    python3 port_tools/epochs_around_profile.py MODE

MODE "cuda" profiles CPU and CUDA activities, "cpu" CPU activities only,
"none" nothing (the control). Prints the mean epoch time of each model over
3 epochs, in 7 rounds; the window comes before round 2. Needs a GPU; run
the three modes as three processes in one call (~1 minute each).
"""

import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

mode = sys.argv[1]
cs.fp32_matmuls()


def epochs(engine, n):
    out = []
    for _ in range(n):
        t = time.perf_counter()
        float(engine.epoch_fn.run(engine.generator))
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return sum(out) / n


with tempfile.TemporaryDirectory() as root:
    data = cs.mf_split()
    engines = {
        "mf-dense": cs.built_engine(cs.MatrixFactorization(cs.mf_config(0, root, sparse_optim=False)), data)[1],
        "lightgcn": cs.built_engine(cs.LightGCN(cs.graph_config("LightGCN", 0, root)), data)[1],
    }
    for e in engines.values():
        epochs(e, 1)
    for rnd in range(7):
        if rnd == 2 and mode != "none":
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if mode == "cuda" else [])
            e = engines["mf-dense"]
            with profile(activities=acts) as prof:
                e.epoch_fn.run_batches(*(x[:10] for x in e.epoch_fn.form(e.generator)), generator=e.generator)
                torch.cuda.synchronize()
            n = len(prof.key_averages())
            print(f"{mode}: profiled 10 steps ({n} keys)", flush=True)
        line = " ".join(f"{name} {epochs(e, 3):.4f}" for name, e in engines.items())
        print(f"{mode} round {rnd}: mean epoch s: {line}", flush=True)
