#!/usr/bin/env python3
"""The port's GMF, MLP and NCF spreads on the structured synthetic split.

    python3 port_tools/port_ncf_band.py [GMF] [MLP] [NCF]

Trains each model once for each of seeds 0-9 on the CPU, on one thread (a
sum split over threads may take another order on another run), as
``chip_smoke.py``'s phase 18 does on the card (``chip_smoke.ncf_config``:
the shipped config on the structured split, one evaluation copy, capped
at ``chip_smoke.NCF_EPOCHS``) through ``XRecommender(cfg,
device="cpu").train(data)``, and prints
what ``port_tools/jax_ncf_band.py`` prints for the JAX package: each seed's
best valid ndcg@10, best epoch, epochs run and test ndcg@10, then each
model's mean and sample standard deviation. With model names, only those
train. The thirty runs take ~20 minutes.
"""

import json
import sys
import tempfile

import torch
from jax_mf_band import REPO, SEEDS, summarize

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def main():
    torch.set_num_threads(1)
    data = chip_smoke.mf_split()
    summaries = {}
    with tempfile.TemporaryDirectory() as root:
        for name in sys.argv[1:] or list(chip_smoke.NCF_FAMILY):
            runs = []
            for seed in SEEDS:
                rec = chip_smoke.NCF_FAMILY[name][0](chip_smoke.ncf_config(name, seed, root), device="cpu")
                result = rec.train(data)
                run = {
                    "model": name, "seed": seed, "valid_best": result["valid_metric"],
                    "best_epoch": result["best_epoch"], "epochs_run": len(rec.engine.bookkeeper.history),
                    "test_ndcg@10": rec.test()["ndcg@10"], "train_s": result["run_time"],
                }
                runs.append(run)
                print(json.dumps(run), flush=True)
            summaries[name] = summarize(runs)
            print(json.dumps({"model": name, **summaries[name]}), flush=True)
    print(json.dumps(summaries))


if __name__ == "__main__":
    main()
