#!/usr/bin/env python3
"""The port's MF + BPR lazy-Adam spread on the structured synthetic split.

    python3 port_tools/port_mf_band.py [fused | xla]

Needs a GPU. Trains MF once for each of seeds 0-9 as ``chip_smoke.py``'s
lazy-Adam phase does (``chip_smoke.train_mf``: ``configs/mf_default.json``
with ``sparse_optim`` true and ``row_update`` "fused", or "xla": the
function the row-sharded trainer computes within capacity) and prints what
``port_tools/jax_mf_band.py`` prints for the JAX package: each seed's best
valid ndcg@10, best epoch, epochs run and test ndcg@10, then their mean and
sample standard deviation. On the GPU its runs repeat bit for bit.
"""

import json
import sys
import tempfile

from jax_mf_band import REPO, SEEDS, summarize

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def main():
    row_update = sys.argv[1] if len(sys.argv) > 1 else "fused"
    runs = []
    with tempfile.TemporaryDirectory() as root:
        for seed in SEEDS:
            rec, result, _, test = chip_smoke.train_mf(
                f"seed {seed}", seed, root, sparse_optim=True, row_update=row_update)
            run = {
                "seed": seed, "valid_best": result["valid_metric"], "best_epoch": result["best_epoch"],
                "epochs_run": len(rec.engine.bookkeeper.history), "test_ndcg@10": test["ndcg@10"],
                "train_s": result["run_time"],
            }
            runs.append(run)
            print(json.dumps(run), flush=True)
    print(json.dumps(summarize(runs)))


if __name__ == "__main__":
    main()
