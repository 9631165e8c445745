#!/usr/bin/env python3
"""The JAX package's Triple2vec, VBCAR and TVBR bands on the structured synthetic split.

    JAX_PLATFORMS=cpu python port_tools/jax_grocery_band.py [Triple2vec] [VBCAR] [TVBR]

Trains ``beta_recsys_tpu``'s Triple2vec, VBCAR and TVBR recommenders at
their shipped configs (``configs/triple2vec_default.json``: emb 64, 5
negatives, 100,000 basket triples, batch 512, Adam at lr 5e-4, tied item
tables; ``vbcar_default.json``: emb 64, late_dim 128, alpha 0.05, tanh,
random features, lr 1e-3; ``tvbr_default.json``: VBCAR's with time_step 4)
on ``parity_runs/datasets/synthetic_structured`` (leave-one-out, 100
negatives, one evaluation copy) with the synthetic baskets of
``examples/parity_check.py`` (``add_synthetic_baskets``: each user's train
interactions in timestamp order, five to a basket), once for each of seeds
0-9, each for ``EPOCHS`` epochs, and prints each seed's best valid
ndcg@10, best epoch, test ndcg@10 and per-epoch valid and test ndcg@10,
then each model's mean and sample standard deviation (ddof 1) of the best
valid and the test ndcg@10 over the whole run and read at each cap of
``CAPS`` (the best valid within the cap's epochs and the test at that
epoch, which for these models is test()'s). The JAX engine draws its
triples unseeded, so a seed repeats only its weights and batches. With
model names, only those models train. Two trainings run at once, each in a
process of its own; the thirty take ~25 minutes on an 8-core CPU (a
Triple2vec seed ~15 s, a VBCAR one ~70 s, a TVBR one ~95 s). Results go
under temporary directories.
"""

import json
import os
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

from jax_mf_band import REPO, SEEDS, SPLIT, at_cap, summarize

CONFIGS = {"Triple2vec": "configs/triple2vec_default.json", "VBCAR": "configs/vbcar_default.json",
           "TVBR": "configs/tvbr_default.json"}
EPOCHS = 20  # each run's length
CAPS = (5, 10, 15)


def run(task):
    """One seed's training of one model."""
    name, seed = task
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from beta_recsys_tpu import recommenders
    from beta_recsys_tpu.config import load_config
    from beta_recsys_tpu.datasets.data_split import load_split_data
    from beta_recsys_tpu.datasets.synthetic import add_synthetic_baskets

    cls = getattr(recommenders, name)
    train, valid, test = load_split_data(SPLIT, n_test=1)
    data = cls.data_class((add_synthetic_baskets(train), valid, test))
    with tempfile.TemporaryDirectory() as root:
        cfg = load_config(os.path.join(REPO, CONFIGS[name])).replace(
            system={"root_dir": root, "seed": seed},
            dataset={"dataset": "synthetic_structured", "n_test": 1},
            model={"max_epoch": EPOCHS},
        )
        rec = cls(cfg)
        result = rec.train(data)
        history = rec.engine.bookkeeper.history
        return {
            "model": name, "seed": seed, "epochs": EPOCHS, "valid_best": result["valid_metric"],
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
                           **{f"cap_{cap}": summarize([at_cap(r, cap) for r in runs]) for cap in CAPS}}
        print(json.dumps({"model": name, **summaries[name]}), flush=True)
    print(json.dumps(summaries))


if __name__ == "__main__":
    main()
