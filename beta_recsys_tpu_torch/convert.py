"""Carry the JAX package's parameters across to the port.

``sasrec_params_from_jax`` turns a SASRec params tree of
``beta_recsys_tpu/models/sasrec.py`` (``init_params``, or ``raw["params"]``
of a checkpoint) into the port's ``state_dict``. The port keeps the JAX
layout: projection weights stay (in, out) and are applied as ``x @ w``, so
nothing is transposed; ``item_emb`` keeps its padding row 0. The
``blocks`` list may come as a list (``init_params``) or as a dict keyed
"0", "1", ... (a checkpoint's msgpack tree).
"""

import numpy as np
import torch


def _flatten(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flatten(value, f"{prefix}{key}."))
        return out
    return {prefix[:-1]: torch.from_numpy(np.array(tree, dtype=np.float32))}


def sasrec_params_from_jax(params):
    """{dotted name: float32 tensor} for ``SASRec.load_state_dict``."""
    return _flatten(params)
