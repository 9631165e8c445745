#!/usr/bin/env python3
"""The JAX package's UltraGCN and MixGCF bands on the structured synthetic split.

    JAX_PLATFORMS=cpu python port_tools/jax_ultragcn_band.py [UltraGCN] [MixGCF]

Trains ``beta_recsys_tpu``'s UltraGCN and MixGCF recommenders at their
shipped configs (``configs/ultragcn_default.json``: emb 64, 50 negatives a
positive, negative weight 50, 10 item-item neighbours, Adam at lr 1e-3;
``configs/mixgcf_default.json``: emb 64, three hops over the ``sym``
adjacency, mean pool, 16 candidate negatives mixed into one, edge and
message dropout 0.1, Adam at lr 1e-3; both batch 1,024) on
``parity_runs/datasets/synthetic_structured`` (leave-one-out, 100
negatives, one evaluation copy) once for each of seeds 0-9, each capped at
``CAPS[model]`` epochs (early stop after 20 epochs without gain still
applies), and prints each seed's best valid ndcg@10, best epoch, epochs
run, test ndcg@10 and its per-epoch valid and test ndcg@10, then each
model's mean and sample standard deviation (ddof 1) of the best valid and
the test ndcg@10. ``chip_smoke.py`` trains the port at the same caps and
holds it to mean +- 3 std. With model names, only those models train.
Results go under a temporary directory; UltraGCN's ten seeds take ~4
minutes on a CPU, MixGCF's ~8.
"""

import json
import os
import sys
import tempfile

from jax_mf_band import REPO, SEEDS, SPLIT, summarize

CONFIGS = {"UltraGCN": "configs/ultragcn_default.json", "MixGCF": "configs/mixgcf_default.json"}
# Epochs each training may run (chip_smoke.py's ULTRAGCN_CAPS).
CAPS = {"UltraGCN": 10, "MixGCF": 5}


def main():
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from beta_recsys_tpu.config import load_config
    from beta_recsys_tpu.data.base_data import BaseData
    from beta_recsys_tpu.datasets.data_split import load_split_data
    from beta_recsys_tpu.recommenders import MixGCF, UltraGCN

    recommenders = {"UltraGCN": UltraGCN, "MixGCF": MixGCF}
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
                    model={"max_epoch": CAPS[name]},
                )
                rec = recommenders[name](cfg)
                result = rec.train(data)
                history = rec.engine.bookkeeper.history
                run = {
                    "model": name, "seed": seed, "cap": CAPS[name], "valid_best": result["valid_metric"],
                    "best_epoch": result["best_epoch"], "epochs_run": len(history),
                    "test_ndcg@10": rec.test()["ndcg@10"], "train_s": result["run_time"],
                    "valid_curve": [h["valid"]["ndcg@10"] for h in history],
                    "test_curve": [h["test"].get("ndcg@10") for h in history],
                }
                runs.append(run)
                print(json.dumps(run), flush=True)
            summaries[name] = summarize(runs)
            print(json.dumps({"model": name, "cap": CAPS[name], **summaries[name]}), flush=True)
    print(json.dumps(summaries))


if __name__ == "__main__":
    main()
