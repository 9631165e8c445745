#!/usr/bin/env python3
"""The port's SASRec spread on the structured synthetic split.

    python3 port_tools/port_sasrec_band.py

Needs a GPU. Trains SASRec once for each of seeds 0-9 as ``chip_smoke.py``'s
training phase does (``chip_smoke.train_sasrec``: the trained checkpoint's
config, the flash kernels forward and backward) and prints what
``port_tools/jax_sasrec_band.py`` prints for the JAX package: each seed's
best valid ndcg@10, best epoch, epochs run and test ndcg@10, then their mean
and sample standard deviation. On the GPU its runs repeat bit for bit.
"""

import json
import sys
import tempfile

from jax_mf_band import REPO, SEEDS, SPLIT, summarize

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def main():
    data = chip_smoke.SequentialData(chip_smoke.load_split_data(SPLIT, n_test=1))
    runs = []
    with tempfile.TemporaryDirectory() as root:
        for seed in SEEDS:
            rec, result, _ = chip_smoke.train_sasrec(f"seed {seed}", seed, root, data)
            run = {
                "seed": seed, "valid_best": result["valid_metric"], "best_epoch": result["best_epoch"],
                "epochs_run": len(rec.engine.bookkeeper.history), "test_ndcg@10": rec.test()["ndcg@10"],
                "train_s": result["run_time"],
            }
            runs.append(run)
            print(json.dumps(run), flush=True)
    print(json.dumps(summarize(runs)))


if __name__ == "__main__":
    main()
