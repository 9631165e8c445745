from .mf import MF
from .sasrec import SASRec

MODELS = {"MF": MF, "SASRec": SASRec}


def build_model(config, n_users, n_items, artifacts=None, device=None):
    """Instantiate the model the config's ``model`` key names."""
    name = config.get("model")
    if name not in MODELS:
        raise ValueError(f"model {name!r} is not ported yet; ported: {sorted(MODELS)}")
    return MODELS[name](config, n_users, n_items, artifacts=artifacts, device=device)
