#!/usr/bin/env python3
"""The JAX package's SGL, SimGCL, BUIR and LCFN bands on the structured synthetic split.

    JAX_PLATFORMS=cpu python port_tools/jax_ssl_band.py [SGL] [SimGCL] [BUIR] [LCFN]

Trains ``beta_recsys_tpu``'s SGL, SimGCL, BUIR and LCFN recommenders at
their shipped configs (``configs/sgl_default.json``: emb 64, 3 layers over
the ``sym`` adjacency, edge dropout 0.1, both_side InfoNCE at 0.2 weighted
0.1; ``simgcl_default.json``: 3 layers, eps 0.1, lambda 0.5;
``buir_default.json``: 3 layers, momentum 0.995; ``lcfn_default.json``:
one layer, cut_off 0.2, lamda 1e-3; all batch 1,024 and Adam at lr 1e-3) on
``parity_runs/datasets/synthetic_structured`` (leave-one-out, 100
negatives, one evaluation copy) once for each of seeds 0-9, each for
``EPOCHS[model]`` epochs (early stop after 20 epochs without gain still
applies, so a run is the first epochs of a longer one), and prints each
seed's best valid ndcg@10, best epoch, test ndcg@10 and per-epoch valid and
test ndcg@10, then each model's mean and sample standard deviation (ddof 1)
of the best valid and the test ndcg@10 over the whole run and read at each
cap of ``CAPS[model]`` (the best valid within the cap's epochs and the test
at that epoch). ``chip_smoke.py`` trains the port at one of those caps
(``SSL_FAMILY``) and holds it to mean +- 3 std. With model names, only
those models train. Two trainings run at once, each in a process of its
own; the forty take ~60 minutes on an 8-core CPU (an SGL epoch ~15 s, a
SimGCL one ~8 s, BUIR ~3 s, LCFN ~1 s after its ~8 s eigendecomposition).
Results go under temporary directories.
"""

import json
import os
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
from jax_mf_band import REPO, SEEDS, SPLIT, summarize

CONFIGS = {"SGL": "configs/sgl_default.json", "SimGCL": "configs/simgcl_default.json",
           "BUIR": "configs/buir_default.json", "LCFN": "configs/lcfn_default.json"}
EPOCHS = {"SGL": 10, "SimGCL": 10, "BUIR": 20, "LCFN": 30}  # each run's length
CAPS = {"SGL": (3, 5, 10), "SimGCL": (3, 5, 10), "BUIR": (3, 5, 10, 20), "LCFN": (5, 10, 20, 30)}


def run(task):
    """One seed's training of one model."""
    name, seed = task
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from beta_recsys_tpu import recommenders
    from beta_recsys_tpu.config import load_config
    from beta_recsys_tpu.data.base_data import BaseData
    from beta_recsys_tpu.datasets.data_split import load_split_data

    data = BaseData(load_split_data(SPLIT, n_test=1))
    with tempfile.TemporaryDirectory() as root:
        cfg = load_config(os.path.join(REPO, CONFIGS[name])).replace(
            system={"root_dir": root, "seed": seed},
            dataset={"dataset": "synthetic_structured", "n_test": 1},
            model={"max_epoch": EPOCHS[name]},
        )
        rec = getattr(recommenders, name)(cfg)
        result = rec.train(data)
        history = rec.engine.bookkeeper.history
        return {
            "model": name, "seed": seed, "epochs": EPOCHS[name], "valid_best": result["valid_metric"],
            "best_epoch": result["best_epoch"], "epochs_run": len(history),
            "test_ndcg@10": rec.test()["ndcg@10"], "train_s": result["run_time"],
            "valid_curve": [h["valid"]["ndcg@10"] for h in history],
            "test_curve": [h["test"].get("ndcg@10") for h in history],
        }


def at_cap(r, cap):
    """The run as it would have ended after ``cap`` epochs."""
    valid = r["valid_curve"][:cap]
    best = int(np.argmax(valid))  # the first best, as the bookkeeper keeps it
    return {"seed": r["seed"], "valid_best": valid[best], "test_ndcg@10": r["test_curve"][best]}


def main():
    names = sys.argv[1:] or list(CONFIGS)
    by_model = {name: [] for name in names}
    with ProcessPoolExecutor(max_workers=2, mp_context=get_context("spawn")) as pool:
        for r in pool.map(run, [(name, seed) for name in names for seed in SEEDS]):
            by_model[r["model"]].append(r)
            print(json.dumps(r), flush=True)
    summaries = {}
    for name, runs in by_model.items():
        summaries[name] = {"run": summarize(runs),
                           **{f"cap_{cap}": summarize([at_cap(r, cap) for r in runs]) for cap in CAPS[name]}}
        print(json.dumps({"model": name, **summaries[name]}), flush=True)
    print(json.dumps(summaries))


if __name__ == "__main__":
    main()
