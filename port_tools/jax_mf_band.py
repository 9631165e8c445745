#!/usr/bin/env python3
"""The JAX package's MF + BPR lazy-Adam band on the structured synthetic split.

    JAX_PLATFORMS=cpu python port_tools/jax_mf_band.py [--compute_dtype bfloat16] [--row_update unified_bf16]

Trains ``beta_recsys_tpu``'s MatrixFactorization from
``configs/mf_default.json`` with ``sparse_optim`` true and ``row_update``
"xla" (the arithmetic of "fused", ``tests/test_rowadam_kernel.py``; with
``--row_update``, that layout: "unified_bf16" follows its own trajectory,
its moments rounded to bfloat16) on
``parity_runs/datasets/synthetic_structured`` (leave-one-out, 100 negatives,
one evaluation copy) once for each of seeds 0-9, with early stop (with
``--compute_dtype``, the model's compute dtype: bfloat16 mixed precision),
and prints
each seed's best valid ndcg@10, best epoch, epochs run, test ndcg@10, the
lazy-Adam state's dropped count (the "compact" layout's rows past its
capacity) and per-epoch valid and test ndcg@10, then the mean and the sample standard
deviation (ddof 1) of the best valid and the test ndcg@10 over the whole
run and read at each cap of ``CAPS`` (the best valid within the cap's
epochs and the test at that epoch, which for MF is test()'s).
``chip_smoke.py`` holds the port's lazy-Adam trainer to mean +- 3 std (phase
3 at a cap, the 4-card run to early stop). Results go under a temporary
directory; the ten seeds take ~5 minutes on a CPU.
"""

import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(
    REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100"
)
SEEDS = range(10)
CAPS = (5, 10, 15, 20, 30, 40)


def summarize(runs):
    """Mean and sample std (ddof 1) of the best valid and test ndcg@10."""
    summary = {"seeds": [r["seed"] for r in runs]}
    for key in ("valid_best", "test_ndcg@10"):
        values = np.array([r[key] for r in runs])
        summary[f"{key}_mean"] = float(values.mean())
        summary[f"{key}_std"] = float(values.std(ddof=1))
    return summary


def at_cap(r, cap):
    """The run as it would have ended after ``cap`` epochs."""
    valid = r["valid_curve"][:cap]
    best = int(np.argmax(valid))  # the first best, as the bookkeeper keeps it
    return {"seed": r["seed"], "valid_best": valid[best], "test_ndcg@10": r["test_curve"][best]}


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--compute_dtype", default=None, help="e.g. bfloat16 (default: float32 throughout)")
    parser.add_argument("--row_update", default="xla", help="the lazy-Adam row layout (default: xla)")
    args = parser.parse_args()
    compute_dtype, row_update = args.compute_dtype, args.row_update
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from beta_recsys_tpu.config import load_config
    from beta_recsys_tpu.data.base_data import BaseData
    from beta_recsys_tpu.datasets.data_split import load_split_data
    from beta_recsys_tpu.recommenders import MatrixFactorization

    data = BaseData(load_split_data(SPLIT, n_test=1))
    runs = []
    with tempfile.TemporaryDirectory() as root:
        for seed in SEEDS:
            cfg = load_config(os.path.join(REPO, "configs/mf_default.json")).replace(
                system={"root_dir": root, "seed": seed},
                dataset={"dataset": "synthetic_structured", "n_test": 1},
                model={"sparse_optim": True, "row_update": row_update,
                       **({"compute_dtype": compute_dtype} if compute_dtype else {})},
            )
            rec = MatrixFactorization(cfg)
            result = rec.train(data)
            history = rec.engine.bookkeeper.history
            run = {
                "seed": seed, "valid_best": result["valid_metric"],
                "best_epoch": result["best_epoch"],
                "epochs_run": len(history),
                "test_ndcg@10": rec.test()["ndcg@10"], "train_s": result["run_time"],
                "dropped": int(rec.engine.opt_state[0].get("dropped", 0)),
                "valid_curve": [h["valid"]["ndcg@10"] for h in history],
                "test_curve": [h["test"].get("ndcg@10") for h in history],
            }
            runs.append(run)
            print(json.dumps(run), flush=True)
    print(json.dumps({"compute_dtype": compute_dtype, "row_update": row_update, "run": summarize(runs),
                      **{f"cap_{cap}": summarize([at_cap(r, cap) for r in runs]) for cap in CAPS}}))


if __name__ == "__main__":
    main()
