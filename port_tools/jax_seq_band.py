#!/usr/bin/env python3
"""The JAX package's TiSASRec, NARM and VAECF bands on the structured synthetic split.

    JAX_PLATFORMS=cpu python port_tools/jax_seq_band.py [TiSASRec] [NARM] [VAECF]

Trains ``beta_recsys_tpu``'s TiSASRec, NARM and VAECF recommenders at their
shipped configs (``configs/tisasrec_default.json``: emb 64, 2 blocks, 2
heads, maxlen 50, time_span 256, batch 128, dropout 0.2;
``narm_default.json``: emb 50, hidden 100, maxlen 19, batch 512, input and
hidden dropout 0.25 and 0.5; ``vaecf_default.json``: z 10, encoder [20],
tanh, mult likelihood, batch 128; all Adam at lr 1e-3) on
``parity_runs/datasets/synthetic_structured`` (leave-one-out, 100
negatives, one evaluation copy) once for each of seeds 0-9, each for
``EPOCHS[model]`` epochs (early stop after 20 epochs without gain still
applies: VAECF's 200 run to it), and prints each seed's best valid
ndcg@10, best epoch, test ndcg@10 and per-epoch valid and test ndcg@10,
then each model's mean and sample standard deviation (ddof 1) of the best
valid and the test ndcg@10 over the whole run and read at each cap of
``CAPS[model]`` (the best valid within the cap's epochs and the test at
that epoch). A capped test is the per-epoch test evaluator's, which scores
TiSASRec and NARM against the train context alone; the whole run's is
``test()``'s, against the train+valid context: ``chip_smoke.py``
(``SEQ_BANDS``) holds ``test()`` to whole runs as long as its caps. With
model names, only those models train. Two
trainings run at once, each in a process of its own; the thirty take ~21
minutes on an 8-core CPU (a TiSASRec seed ~60 s, a NARM one ~140 s, a VAECF
one ~20 s). Results go under temporary directories.
"""

import json
import os
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

from jax_mf_band import REPO, SEEDS, SPLIT, at_cap, summarize

CONFIGS = {"TiSASRec": "configs/tisasrec_default.json", "NARM": "configs/narm_default.json",
           "VAECF": "configs/vaecf_default.json"}
EPOCHS = {"TiSASRec": 10, "NARM": 5, "VAECF": 200}  # each run's length
CAPS = {"TiSASRec": (3, 5, 10), "NARM": (3, 5), "VAECF": ()}


def run(task):
    """One seed's training of one model."""
    name, seed = task
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from beta_recsys_tpu import recommenders
    from beta_recsys_tpu.config import load_config
    from beta_recsys_tpu.datasets.data_split import load_split_data

    cls = getattr(recommenders, name)
    data = cls.data_class(load_split_data(SPLIT, n_test=1))
    with tempfile.TemporaryDirectory() as root:
        cfg = load_config(os.path.join(REPO, CONFIGS[name])).replace(
            system={"root_dir": root, "seed": seed},
            dataset={"dataset": "synthetic_structured", "n_test": 1},
            model={"max_epoch": EPOCHS[name]},
        )
        rec = cls(cfg)
        result = rec.train(data)
        history = rec.engine.bookkeeper.history
        return {
            "model": name, "seed": seed, "epochs": EPOCHS[name], "valid_best": result["valid_metric"],
            "best_epoch": result["best_epoch"], "epochs_run": len(history),
            "test_ndcg@10": rec.test()["ndcg@10"], "train_s": result["run_time"],
            "valid_curve": [h["valid"]["ndcg@10"] for h in history],
            "test_curve": [h["test"].get("ndcg@10") for h in history],
        }


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
