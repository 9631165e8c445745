from .buir import BUIR
from .cmn import CMN
from .gmf import GMF
from .knn import ItemKNN, UserKNN
from .lcfn import LCFN
from .lightgcn import LightGCN
from .mf import MF
from .mixgcf import MixGCF
from .mlp import MLP
from .narm import NARM
from .ncf import NeuMF
from .ngcf import NGCF
from .pairwise_gmf import PairwiseGMF
from .sasrec import SASRec
from .sgl import SGL
from .simgcl import SimGCL
from .tisasrec import TiSASRec
from .triple2vec import Triple2vec
from .tvbr import TVBR
from .ultragcn import UltraGCN
from .vaecf import VAECF
from .vbcar import VBCAR

# The JAX registry's names (beta_recsys_tpu/models/__init__.py), every model ported.
MODELS = {
    "MF": MF, "mf": MF, "GMF": GMF, "MLP": MLP, "NCF": NeuMF, "NeuMF": NeuMF, "ncf": NeuMF, "SASRec": SASRec,
    "sasrec": SASRec,
    "LightGCN": LightGCN, "lightgcn": LightGCN, "NGCF": NGCF, "ngcf": NGCF, "PairwiseGMF": PairwiseGMF,
    "CMN": CMN, "cmn": CMN, "UltraGCN": UltraGCN, "ultragcn": UltraGCN, "MixGCF": MixGCF, "mixgcf": MixGCF,
    "SGL": SGL, "sgl": SGL, "SimGCL": SimGCL, "simgcl": SimGCL, "BUIR": BUIR, "buir": BUIR,
    "LCFN": LCFN, "lcfn": LCFN, "TiSASRec": TiSASRec, "tisasrec": TiSASRec, "NARM": NARM, "narm": NARM,
    "VAECF": VAECF, "vaecf": VAECF, "Triple2vec": Triple2vec, "triple2vec": Triple2vec, "VBCAR": VBCAR,
    "vbcar": VBCAR, "TVBR": TVBR, "tvbr": TVBR, "UserKNN": UserKNN, "userKNN": UserKNN, "ItemKNN": ItemKNN,
    "itemKNN": ItemKNN,
}


def build_model(config, n_users, n_items, artifacts=None, device=None):
    """Instantiate the model the config's ``model`` key names."""
    name = config.get("model")
    if name not in MODELS:
        raise ValueError(f"Unknown model {name!r}; known: {sorted(MODELS)}")
    return MODELS[name](config, n_users, n_items, artifacts=artifacts, device=device)
