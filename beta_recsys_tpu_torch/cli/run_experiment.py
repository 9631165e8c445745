"""Compare MF, NeuMF and LightGCN on one dataset through ``Experiment``.

Counterpart of ``examples/run_experiment.py``, with ``--device`` (the card
by default):

    python -m beta_recsys_tpu_torch.cli.run_experiment --dataset synthetic_structured
"""

import argparse

from ..config import load_config
from ..data.base_data import BaseData
from ..datasets import load_split_dataset
from ..experiment import Experiment
from ..recommenders import LightGCN, MatrixFactorization, NeuCF


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="ml_100k")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    mf_cfg = load_config("configs/mf_default.json", {"dataset": args.dataset})
    ncf_cfg = load_config("configs/ncf_default.json", {"dataset": args.dataset})
    gcn_cfg = load_config("configs/lightgcn_default.json", {"dataset": args.dataset})
    data = BaseData(load_split_dataset(mf_cfg.to_dict()))
    experiment = Experiment(
        datasets=[data],
        models=[MatrixFactorization(mf_cfg, device=args.device), NeuCF(ncf_cfg, device=args.device),
                LightGCN(gcn_cfg, device=args.device)],
        metrics=["ndcg", "recall", "precision", "map"],
        eval_scopes=[5, 10, 20],
    )
    return experiment.run()


if __name__ == "__main__":
    main()
