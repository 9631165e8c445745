#!/usr/bin/env python3
"""The port's Triple2vec, VBCAR and TVBR spreads on the structured synthetic split.

    python3 port_tools/port_grocery_band.py [Triple2vec] [VBCAR] [TVBR]

Trains each model once for each of seeds 0-9 on the CPU, on one thread (a
sum split over threads may take another order on another run), as
``chip_smoke.py``'s phases 32-33 do on the card (``chip_smoke.grocery_config``:
the shipped config on the structured split with its synthetic baskets, one
evaluation copy, capped at ``chip_smoke.GROCERY_FAMILY``'s epochs) through
``XRecommender(cfg, device="cpu").train(data)``, and prints what
``port_tools/jax_grocery_band.py`` prints for the JAX package: each seed's
best valid ndcg@10, best epoch, epochs run, test ndcg@10 and per-epoch
valid and test ndcg@10, then each model's mean and sample standard
deviation. With model names, only those train; run one process a model (an
epoch on one thread: Triple2vec ~2 s, VBCAR ~11 s, TVBR ~25 s).
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
    data = chip_smoke.grocery_split()
    summaries = {}
    with tempfile.TemporaryDirectory() as root:
        for name in sys.argv[1:] or list(chip_smoke.GROCERY_FAMILY):
            runs = []
            for seed in SEEDS:
                rec = chip_smoke.GROCERY_FAMILY[name][0](chip_smoke.grocery_config(name, seed, root), device="cpu")
                result = rec.train(data)
                history = rec.engine.bookkeeper.history
                run = {
                    "model": name, "seed": seed, "cap": chip_smoke.GROCERY_FAMILY[name][2],
                    "valid_best": result["valid_metric"], "best_epoch": result["best_epoch"],
                    "epochs_run": len(history), "test_ndcg@10": rec.test()["ndcg@10"],
                    "train_s": result["run_time"],
                    "valid_curve": [h["valid"]["ndcg@10"] for h in history],
                    "test_curve": [h["test"].get("ndcg@10") for h in history],
                }
                runs.append(run)
                print(json.dumps(run), flush=True)
            summaries[name] = summarize(runs)
            print(json.dumps({"model": name, **summaries[name]}), flush=True)
    print(json.dumps(summaries))


if __name__ == "__main__":
    main()
