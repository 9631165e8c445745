#!/usr/bin/env python3
"""The JAX package's PairwiseGMF and CMN bands on the structured synthetic split.

    JAX_PLATFORMS=cpu python port_tools/jax_cmn_band.py

For each of seeds 0-9, trains ``beta_recsys_tpu``'s PairwiseGMFRecommender
at ``configs/pairwise_gmf_default.json`` (emb 50, BPR, batch 128, Adam at
lr 1e-3) for ``GMF_CAP`` epochs, then its CMN at ``configs/cmn_default.json``
(two hops, batch 128, rmsprop at lr 1e-3) for ``CMN_CAP`` epochs with its
user and item memories warm-started from that PairwiseGMF's best
parameters, on ``parity_runs/datasets/synthetic_structured`` (leave-one-out,
100 negatives, one evaluation copy). Prints each training's best valid
ndcg@10, best epoch, test ndcg@10 and per-epoch valid and test ndcg@10,
then each model's mean and sample standard deviation (ddof 1) of the best
valid and the test ndcg@10. ``chip_smoke.py`` trains the port at the same
caps and holds it to mean +- 3 std.

CMN's evaluation scores each candidate through a (614, 50) gather of two
user tables (the most popular item's 614 training users); in one call over
the split's 95,243 candidates that peaks at ~24 GB, so here the candidates
are scored in blocks of ``EVAL_BLOCK`` users (the same function, a block at
a time). Two seeds train at once, each in a process of its own; the twenty
trainings take ~25 minutes on an 8-core CPU. Results go under temporary
directories.
"""

import json
import os
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

from jax_mf_band import REPO, SEEDS, SPLIT, summarize

GMF_CAP = 5  # chip_smoke.CAPPED_FAMILY's caps
CMN_CAP = 3
EVAL_BLOCK = 32


def run_seed(seed):
    """(PairwiseGMF run, CMN run) of one seed."""
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from beta_recsys_tpu.config import load_config
    from beta_recsys_tpu.data.base_data import BaseData
    from beta_recsys_tpu.datasets.data_split import load_split_data
    from beta_recsys_tpu.models import register_model
    from beta_recsys_tpu.models.cmn import CMN as CMNModel
    from beta_recsys_tpu.recommenders import CMN, PairwiseGMFRecommender

    class BlockedCMN(CMNModel):
        def score_candidates(self, params, users, cand_items):
            n, c = cand_items.shape
            pad = (-n) % EVAL_BLOCK
            users = jnp.concatenate([users, jnp.repeat(users[-1:], pad)])
            cand_items = jnp.concatenate([cand_items, jnp.repeat(cand_items[-1:], pad, axis=0)])
            out = jax.lax.map(lambda blk: CMNModel.score_candidates(self, params, *blk),
                              (users.reshape(-1, EVAL_BLOCK), cand_items.reshape(-1, EVAL_BLOCK, c)))
            return out.reshape(-1, c)[:n]

    register_model("CMN", BlockedCMN)
    data = BaseData(load_split_data(SPLIT, n_test=1))
    runs = []
    with tempfile.TemporaryDirectory() as root:
        pretrained = {}
        for name, path, cap in (("PairwiseGMF", "configs/pairwise_gmf_default.json", GMF_CAP),
                                ("CMN", "configs/cmn_default.json", CMN_CAP)):
            cfg = load_config(os.path.join(REPO, path)).replace(
                system={"root_dir": root, "seed": seed},
                dataset={"dataset": "synthetic_structured", "n_test": 1},
                model={"max_epoch": cap},
            )
            rec = PairwiseGMFRecommender(cfg) if name == "PairwiseGMF" else CMN(cfg, **pretrained)
            result = rec.train(data)
            if name == "PairwiseGMF":
                best = rec._serving_params(True)
                pretrained = {"user_embeddings": jax.device_get(best["user_memory"]),
                              "item_embeddings": jax.device_get(best["item_memory"])}
            history = rec.engine.bookkeeper.history
            runs.append({
                "model": name, "seed": seed, "cap": cap, "valid_best": result["valid_metric"],
                "best_epoch": result["best_epoch"], "epochs_run": len(history),
                "test_ndcg@10": rec.test()["ndcg@10"], "train_s": result["run_time"],
                "valid_curve": [h["valid"]["ndcg@10"] for h in history],
                "test_curve": [h["test"].get("ndcg@10") for h in history],
            })
    return runs


def main():
    by_model = {"PairwiseGMF": [], "CMN": []}
    with ProcessPoolExecutor(max_workers=2, mp_context=get_context("spawn")) as pool:
        for runs in pool.map(run_seed, SEEDS):
            for run in runs:
                by_model[run["model"]].append(run)
                print(json.dumps(run), flush=True)
    summaries = {name: summarize(runs) for name, runs in by_model.items()}
    for name, summary in summaries.items():
        print(json.dumps({"model": name, "cap": by_model[name][0]["cap"], **summary}), flush=True)
    print(json.dumps(summaries))


if __name__ == "__main__":
    main()
