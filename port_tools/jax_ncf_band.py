#!/usr/bin/env python3
"""The JAX package's GMF, MLP and NCF bands on the structured synthetic split.

    JAX_PLATFORMS=cpu python port_tools/jax_ncf_band.py [GMF] [MLP] [NCF]

Trains ``beta_recsys_tpu``'s GMFRecommender, MLPRecommender and NeuCF at
their shipped configs (``configs/gmf_default.json``, ``mlp_default.json``,
``ncf_default.json``: BCE on each positive beside 4 sampled negatives, batch
400, Adam at lr 1e-3, early stop after 20 epochs without gain) on
``parity_runs/datasets/synthetic_structured`` (leave-one-out, 100 negatives,
one evaluation copy) once for each of seeds 0-9, and prints each seed's best
valid ndcg@10, best epoch, epochs run, test ndcg@10 and per-epoch valid and
test ndcg@10, then each model's mean and sample standard deviation (ddof 1)
of the best valid and the test ndcg@10 over the whole run and read at each
cap of ``CAPS`` (the best valid within the cap's epochs and the test at that
epoch). ``chip_smoke.py`` holds the port's trainings, capped at
``NCF_EPOCHS``, to mean +- 3 std at that cap.
With model names, only those models train. Results go under a temporary
directory; the thirty runs take ~30 minutes on a CPU.
"""

import json
import os
import sys
import tempfile

from jax_mf_band import REPO, SEEDS, SPLIT, at_cap, summarize

CONFIGS = {"GMF": "configs/gmf_default.json", "MLP": "configs/mlp_default.json", "NCF": "configs/ncf_default.json"}
CAPS = (8, 10, 15, 20, 25)


def main():
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from beta_recsys_tpu.config import load_config
    from beta_recsys_tpu.data.base_data import BaseData
    from beta_recsys_tpu.datasets.data_split import load_split_data
    from beta_recsys_tpu.recommenders import GMFRecommender, MLPRecommender, NeuCF

    recommenders = {"GMF": GMFRecommender, "MLP": MLPRecommender, "NCF": NeuCF}
    names = sys.argv[1:] or list(CONFIGS)
    data = BaseData(load_split_data(SPLIT, n_test=1))
    summaries = {}
    with tempfile.TemporaryDirectory() as root:
        for name in names:
            runs = []
            for seed in SEEDS:
                cfg = load_config(os.path.join(REPO, CONFIGS[name])).replace(
                    system={"root_dir": root, "seed": seed},
                    dataset={"dataset": "synthetic_structured", "n_test": 1},
                )
                rec = recommenders[name](cfg)
                result = rec.train(data)
                history = rec.engine.bookkeeper.history
                run = {
                    "model": name, "seed": seed, "valid_best": result["valid_metric"],
                    "best_epoch": result["best_epoch"],
                    "epochs_run": len(history),
                    "test_ndcg@10": rec.test()["ndcg@10"], "train_s": result["run_time"],
                    "valid_curve": [h["valid"]["ndcg@10"] for h in history],
                    "test_curve": [h["test"].get("ndcg@10") for h in history],
                }
                runs.append(run)
                print(json.dumps(run), flush=True)
            summaries[name] = {"run": summarize(runs),
                               **{f"cap_{cap}": summarize([at_cap(r, cap) for r in runs]) for cap in CAPS}}
            print(json.dumps({"model": name, **summaries[name]}), flush=True)
    print(json.dumps(summaries))


if __name__ == "__main__":
    main()
