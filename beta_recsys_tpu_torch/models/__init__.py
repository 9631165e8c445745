from .gmf import GMF
from .lightgcn import LightGCN
from .mf import MF
from .mlp import MLP
from .ncf import NeuMF
from .ngcf import NGCF
from .sasrec import SASRec

# The JAX registry's names for the ported models (beta_recsys_tpu/models/__init__.py).
MODELS = {
    "MF": MF, "GMF": GMF, "MLP": MLP, "NCF": NeuMF, "NeuMF": NeuMF, "ncf": NeuMF, "SASRec": SASRec,
    "LightGCN": LightGCN, "lightgcn": LightGCN, "NGCF": NGCF, "ngcf": NGCF,
}


def build_model(config, n_users, n_items, artifacts=None, device=None):
    """Instantiate the model the config's ``model`` key names."""
    name = config.get("model")
    if name not in MODELS:
        raise ValueError(f"model {name!r} is not ported yet; ported: {sorted(MODELS)}")
    return MODELS[name](config, n_users, n_items, artifacts=artifacts, device=device)
