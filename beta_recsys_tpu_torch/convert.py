"""Carry parameters between the JAX package's params trees and the port's
``state_dict``s, either way.

``sasrec_params_from_jax`` turns a SASRec params tree of
``beta_recsys_tpu/models/sasrec.py`` (``init_params``, or ``raw["params"]``
of a checkpoint) into the port's ``state_dict``. The port keeps the JAX
layout: projection weights stay (in, out) and are applied as ``x @ w``, so
nothing is transposed; ``item_emb`` keeps its padding row 0. The
``blocks`` list may come as a list (``init_params``) or as a dict keyed
"0", "1", ... (a checkpoint's msgpack tree).

``mf_params_from_jax`` does the same for MF (``beta_recsys_tpu/models/mf.py``:
``user_emb``, ``item_emb``, ``user_bias``, ``item_bias``, 0-d
``global_bias``), ``gmf_params_from_jax``, ``mlp_params_from_jax`` and
``ncf_params_from_jax`` for GMF, MLP and NeuMF (their ``layers`` list comes
as a list or as a dict keyed "0", "1", ..., like SASRec's ``blocks``),
``lightgcn_params_from_jax`` and ``ngcf_params_from_jax`` for LightGCN
(``user_emb``, ``item_emb``) and NGCF (also its ``gc`` and ``bi`` lists of
{w, b}, weights (in, out), as a list or keyed "0", "1", ...), and
``params_to_jax`` is the inverse of all of them: the tree the JAX package's
``from_state_dict`` restores, as float32 numpy arrays. ``flatten_params``,
which they all are, serves the later models as it is (PairwiseGMF, CMN with
its ``hop_maps`` list, UltraGCN, MixGCF); it also takes a tree whose leaves
are tensors (a ``state_dict`` nested by ``nest_dotted``), on any device.
``triple2vec_params_from_jax``, ``vbcar_params_from_jax``,
``tvbr_params_from_jax`` and ``knn_params_from_jax`` name it for the
grocery and neighbourhood models.
"""

import numpy as np
import torch


def flatten_params(tree, prefix=""):
    """{dotted name: float32 CPU tensor} of a params tree of dicts and lists
    whose leaves are arrays or tensors; the values' bits are kept."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(flatten_params(value, f"{prefix}{key}."))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().to("cpu", torch.float32)}
    return {prefix[:-1]: torch.from_numpy(np.array(tree, dtype=np.float32))}


def sasrec_params_from_jax(params):
    """{dotted name: float32 tensor} for ``SASRec.load_state_dict``."""
    return flatten_params(params)


def mf_params_from_jax(params):
    """{name: float32 tensor} for ``MF.load_state_dict``."""
    return flatten_params(params)


def gmf_params_from_jax(params):
    """{name: float32 tensor} for ``GMF.load_state_dict``."""
    return flatten_params(params)


def mlp_params_from_jax(params):
    """{dotted name: float32 tensor} for ``MLP.load_state_dict``."""
    return flatten_params(params)


def ncf_params_from_jax(params):
    """{dotted name: float32 tensor} for ``NeuMF.load_state_dict``."""
    return flatten_params(params)


def lightgcn_params_from_jax(params):
    """{name: float32 tensor} for ``LightGCN.load_state_dict``."""
    return flatten_params(params)


def ngcf_params_from_jax(params):
    """{dotted name: float32 tensor} for ``NGCF.load_state_dict``."""
    return flatten_params(params)


def triple2vec_params_from_jax(params):
    """{name: float32 tensor} for ``Triple2vec.load_state_dict`` (both item
    tables, the untied one too)."""
    return flatten_params(params)


def vbcar_params_from_jax(params):
    """{dotted name: float32 tensor} for ``VBCAR.load_state_dict``: the
    encoders ``fc_<side>_<layer>`` as ``{w, b}``, ``w`` (in, out)."""
    return flatten_params(params)


def tvbr_params_from_jax(params):
    """{dotted name: float32 tensor} for ``TVBR.load_state_dict``: VBCAR's
    and the four ``time2<stat>_<side>`` heads, ``{w, b}`` each."""
    return flatten_params(params)


def knn_params_from_jax(params):
    """{"_": 0-d float32 tensor} for ``UserKNN``/``ItemKNN.load_state_dict``."""
    return flatten_params(params)


def nest_dotted(flat):
    """{dotted name: value} as nested dicts: ``blocks.0.attn.wq`` ->
    {"blocks": {"0": {"attn": {"wq": value}}}}; flat names stay flat."""
    tree = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def params_to_jax(state_dict):
    """A port ``state_dict`` as the JAX params tree: dotted names nest as
    dicts (a list of blocks comes out keyed "0", "1", ..., as a checkpoint
    stores it)."""
    return nest_dotted(
        {name: value.detach().cpu().numpy().astype(np.float32, copy=False) for name, value in state_dict.items()}
    )
