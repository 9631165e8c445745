"""Train (or load) MF and write each user's top-k as a CSV of (col_user,
col_item, col_prediction, rank) rows.

Counterpart of ``examples/serve_topk.py``, with ``--device`` (the card by
default):

    python -m beta_recsys_tpu_torch.cli.serve_topk --dataset synthetic_structured --k 10
    python -m beta_recsys_tpu_torch.cli.serve_topk --load <model_save_dir> --k 10
"""

import argparse
import csv

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="synthetic_structured")
    ap.add_argument("--config", default="configs/mf_default.json")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max_epoch", type=int, default=10)
    ap.add_argument("--users", default=None, help="comma-separated user ids (default: all)")
    ap.add_argument("--load", default=None, help="model_save_dir of a trained run (skips training)")
    ap.add_argument("--root_dir", default="serve_runs")
    ap.add_argument("--out", default="topk.csv")
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..data.base_data import BaseData
    from ..datasets.data_load import DATASET_REGISTRY
    from ..recommenders import MatrixFactorization

    split = DATASET_REGISTRY[args.dataset](root_dir=args.root_dir).load_leave_one_out(n_test=1, n_negative=100)
    data = BaseData(split)
    cfg = load_config(args.config, overrides={"root_dir": args.root_dir, "dataset": args.dataset,
                                              "max_epoch": args.max_epoch, "n_test": 1})
    rec = MatrixFactorization(cfg, device=args.device)
    if args.load:
        rec.load(args.load, data=data)
    else:
        rec.train(data)
    users = [int(u) for u in args.users.split(",")] if args.users else None
    table = rec.recommend(users=users, k=args.k)
    columns = list(table)
    with open(args.out, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(columns)
        writer.writerows(zip(*(np.asarray(table[c]).tolist() for c in columns)))
    n_rows = len(table[columns[0]])
    print(f"wrote {n_rows} rows ({len(np.unique(table['col_user']))} users x top-{args.k}) to {args.out}")
    return table


if __name__ == "__main__":
    main()
