"""Train any recommender from its config.

Counterpart of ``examples/train_model.py``, with the same ``WRAPPERS`` table
and flags, and ``--device`` (the card by default; ``cpu`` to run there):

    python -m beta_recsys_tpu_torch.cli.train_model --model mf --dataset synthetic_structured
    python -m beta_recsys_tpu_torch.cli.train_model --model vaecf --config_file configs/vaecf_default.json
    python -m beta_recsys_tpu_torch.cli.train_model --model mf --tune true --device cpu

The split is read from ``datasets/<dataset>/processed/`` under the working
directory, built there on a miss (``datasets/data_load.py``).
"""

import argparse

from .. import recommenders as rec
from ..config import load_config
from ..datasets import load_split_dataset
from ..utils.common import str2bool

WRAPPERS = {
    "mf": (rec.MatrixFactorization, "configs/mf_default.json"),
    "gmf": (rec.GMFRecommender, "configs/gmf_default.json"),
    "mlp": (rec.MLPRecommender, "configs/mlp_default.json"),
    "ncf": (rec.NeuCF, "configs/ncf_default.json"),
    "pairwise_gmf": (rec.PairwiseGMFRecommender, "configs/pairwise_gmf_default.json"),
    "lightgcn": (rec.LightGCN, "configs/lightgcn_default.json"),
    "ngcf": (rec.NGCF, "configs/ngcf_default.json"),
    "ultragcn": (rec.UltraGCN, "configs/ultragcn_default.json"),
    "sgl": (rec.SGL, "configs/sgl_default.json"),
    "simgcl": (rec.SimGCL, "configs/simgcl_default.json"),
    "mixgcf": (rec.MixGCF, "configs/mixgcf_default.json"),
    "buir": (rec.BUIR, "configs/buir_default.json"),
    "lcfn": (rec.LCFN, "configs/lcfn_default.json"),
    "vaecf": (rec.VAECF, "configs/vaecf_default.json"),
    "cmn": (rec.CMN, "configs/cmn_default.json"),
    "sasrec": (rec.SASRec, "configs/sasrec_default.json"),
    "tisasrec": (rec.TiSASRec, "configs/tisasrec_default.json"),
    "narm": (rec.NARM, "configs/narm_default.json"),
    "triple2vec": (rec.Triple2vec, "configs/triple2vec_default.json"),
    "vbcar": (rec.VBCAR, "configs/vbcar_default.json"),
    "tvbr": (rec.TVBR, "configs/tvbr_default.json"),
    "userknn": (rec.UserKNNRecommender, "configs/userKNN_default.json"),
    "itemknn": (rec.ItemKNNRecommender, "configs/itemKNN_default.json"),
}


def parse_args(fixed_model=None, argv=None):
    parser = argparse.ArgumentParser(description="Train any recommender on an H100 (or the CPU).")
    if fixed_model is None:
        parser.add_argument("--model", type=str, required=True, choices=sorted(WRAPPERS))
    parser.add_argument("--config_file", default=None)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--data_split", type=str, default=None)
    parser.add_argument("--root_dir", type=str, default=None)
    parser.add_argument("--n_test", type=int, default=None)
    parser.add_argument("--n_negative", type=int, default=None)
    parser.add_argument("--emb_dim", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--tune", type=str2bool, default=None)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def run_model(fixed_model=None, argv=None):
    """Train one recommender end to end and test it; ``fixed_model`` pins
    the model key."""
    args = vars(parse_args(fixed_model, argv))
    device = args.pop("device")
    wrapper_cls, default_cfg = WRAPPERS[fixed_model or args.pop("model")]
    config = load_config(args.pop("config_file") or default_cfg, overrides=args)
    data = wrapper_cls.data_class(load_split_dataset(config.to_dict()))
    model = wrapper_cls(config, device=device)
    print("train result:", model.train(data))
    if not config.model.get("tune"):
        print("test result:", model.test())


def main():
    run_model()


if __name__ == "__main__":
    main()
