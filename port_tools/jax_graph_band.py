#!/usr/bin/env python3
"""The JAX package's LightGCN and NGCF bands on the structured synthetic split.

    JAX_PLATFORMS=cpu python port_tools/jax_graph_band.py [LightGCN] [NGCF]

Trains ``beta_recsys_tpu``'s LightGCN and NGCF recommenders at their shipped
configs (``configs/lightgcn_default.json``: emb 64, three layers, edge keep
probability 0.6, the ``row_selfloop`` adjacency, Adam at lr 2.5e-4;
``configs/ngcf_default.json``: emb 64, three layers, message dropout 0.1,
the ``row`` adjacency, Adam at lr 0.01; both batch 1,024 and early stop
after 20 epochs without gain) on ``parity_runs/datasets/synthetic_structured``
(leave-one-out, 100 negatives, one evaluation copy) once for each of seeds
0-9, and prints each seed's best valid ndcg@10, best epoch, epochs run, test
ndcg@10 and its per-epoch valid and test ndcg@10 (so a band at a cap on
epochs can be read from the same runs), then each model's mean and sample
standard deviation (ddof 1) of the best valid and the test ndcg@10.
``chip_smoke.py`` holds the port's trainings to mean +- 3 std. With model
names, only those models train. Results go under a temporary directory; the
twenty runs take ~20-30 minutes on a CPU.
"""

import json
import os
import sys
import tempfile

from jax_mf_band import REPO, SEEDS, SPLIT, summarize

CONFIGS = {"LightGCN": "configs/lightgcn_default.json", "NGCF": "configs/ngcf_default.json"}


def main():
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from beta_recsys_tpu.config import load_config
    from beta_recsys_tpu.data.base_data import BaseData
    from beta_recsys_tpu.datasets.data_split import load_split_data
    from beta_recsys_tpu.recommenders import NGCF, LightGCN

    recommenders = {"LightGCN": LightGCN, "NGCF": NGCF}
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
                    "best_epoch": result["best_epoch"], "epochs_run": len(history),
                    "test_ndcg@10": rec.test()["ndcg@10"], "train_s": result["run_time"],
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
