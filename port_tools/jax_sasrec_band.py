#!/usr/bin/env python3
"""The JAX package's SASRec band on the structured synthetic split.

    JAX_PLATFORMS=cpu python port_tools/jax_sasrec_band.py

Trains ``beta_recsys_tpu``'s SASRec at the config of the trained checkpoint
in ``parity_runs/`` (``SASRec_default_20260821_081415_yybcvt``: emb 64, 2
blocks, 2 heads, maxlen 100, batch 128, dropout 0.1, adam at lr 1e-3) on
``parity_runs/datasets/synthetic_structured`` (leave-one-out, 100 negatives,
one evaluation copy) once for each of seeds 0-9, with early stop, and prints
each seed's best valid ndcg@10, best epoch, epochs run and test ndcg@10, then
the mean and the sample standard deviation (ddof 1) of the best valid and the
test ndcg@10. ``chip_smoke.py`` holds the port's SASRec training to mean +-
3 std. Results go under a temporary directory; a seed takes ~4.5 minutes on
a CPU.
"""

import json
import os
import sys
import tempfile

from jax_mf_band import REPO, SEEDS, SPLIT, summarize

CHECKPOINT = os.path.join(REPO, "parity_runs/checkpoints/SASRec_default_20260821_081415_yybcvt")


def checkpoint_config():
    """The trained checkpoint's config (its metadata.json)."""
    with open(os.path.join(CHECKPOINT, "metadata.json")) as f:
        return json.load(f)["config"]


def main():
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from beta_recsys_tpu.config import Config
    from beta_recsys_tpu.data.sequential_data import SequentialData
    from beta_recsys_tpu.datasets.data_split import load_split_data
    from beta_recsys_tpu.recommenders import SASRec

    data = SequentialData(load_split_data(SPLIT, n_test=1))
    runs = []
    with tempfile.TemporaryDirectory() as root:
        for seed in SEEDS:
            cfg = Config(checkpoint_config()).replace(system={"root_dir": root, "seed": seed})
            rec = SASRec(cfg)
            result = rec.train(data)
            run = {
                "seed": seed, "valid_best": result["valid_metric"],
                "best_epoch": result["best_epoch"],
                "epochs_run": len(rec.engine.bookkeeper.history),
                "test_ndcg@10": rec.test()["ndcg@10"], "train_s": result["run_time"],
            }
            runs.append(run)
            print(json.dumps(run), flush=True)
    print(json.dumps(summarize(runs)))


if __name__ == "__main__":
    main()
