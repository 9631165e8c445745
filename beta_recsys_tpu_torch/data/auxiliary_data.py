"""Auxiliary user and item features for feature-aware models (VBCAR, TVBR).

Counterpart of ``beta_recsys_tpu/data/auxiliary_data.py``: Gaussian features
from ``np.random.default_rng(seed)`` (the JAX package's draws, bit for bit),
or item feature dicts (one_hot, word2vec, bert, cate; ``load_fn`` is
``datasets.data_load.load_item_fea_dic``-shaped) aligned to the dense item
ids and concatenated in that order for a combined type such as
"one_hot_word2vec".
"""

import numpy as np

FEATURE_TYPES = ("one_hot", "word2vec", "bert", "cate")


class Auxiliary:
    """User and item feature matrices (float32) from a config and feature dicts."""

    def __init__(self, config=None, n_users=None, n_items=None, item2id=None, seed=0):
        self.config = config or {}
        self.n_users = n_users
        self.n_items = n_items
        self.item2id = item2id or {}
        self.rng = np.random.default_rng(seed)

    def _random(self, n, dim):
        return self.rng.normal(0.0, 1.0, (n, dim)).astype(np.float32)

    def _dic_to_matrix(self, fea_dic):
        """A {raw item id: vector} dict as rows of the dense item ids (zeros
        where an item has none)."""
        dim = len(next(iter(fea_dic.values())))
        mat = np.zeros((self.n_items, dim), dtype=np.float32)
        for raw_id, vec in fea_dic.items():
            if raw_id in self.item2id:
                mat[self.item2id[raw_id]] = vec
        return mat

    def item_features(self, fea_type="random", dim=64, load_fn=None):
        """Item features: "random", one type, or several types joined by "_"
        (concatenated in ``FEATURE_TYPES`` order)."""
        if fea_type == "random" or load_fn is None:
            return self._random(self.n_items, dim)
        parts = [self._dic_to_matrix(load_fn(t)) for t in FEATURE_TYPES if t in fea_type]
        if not parts:
            return self._random(self.n_items, dim)
        return np.concatenate(parts, axis=1)

    def user_features(self, fea_type="random", dim=64, load_fn=None):
        """User features: random unless a loader is given, which, as in the
        JAX package, is not supported."""
        if fea_type == "random" or load_fn is None:
            return self._random(self.n_users, dim)
        raise NotImplementedError("custom user feature types: pass load_fn output directly")
