"""Grocery (basket) data: ``BaseData`` with basket triples and auxiliary
features.

Counterpart of ``GroceryData`` in ``beta_recsys_tpu/data/grocery_data.py``:
``sample_triples`` draws (user, item, item) basket triples
(``utils/triple_sampler.py``; the train frame needs an order column, e.g.
``datasets/synthetic.add_synthetic_baskets``), time-bucketed for TVBR, and
``user_item_features`` gives VBCAR's and TVBR's feature matrices.
"""

import os

import numpy as np

from ..utils.triple_sampler import Sampler
from .base_data import BaseData


class GroceryData(BaseData):
    """``BaseData`` plus basket triples and user/item features."""

    def sample_triples(self, n_sample, time_step=0, sample_dir=None, dump=False, load_save=False, seed=None):
        """{"users", "item1", "item2"} int32 arrays of ``n_sample`` basket
        triples (and "t", the time bucket, when ``time_step`` > 0), drawn from
        ``np.random.default_rng(seed)``; with ``dump`` they are cached as
        ``triple_<n_sample>_<time_step>.csv`` under ``sample_dir``."""
        sample_file = os.path.join(sample_dir or ".", f"triple_{n_sample}_{time_step}.csv")
        sampler = Sampler(self.train, sample_file, n_sample, dump=dump, load_save=load_save, seed=seed)
        triples = sampler.sample() if time_step == 0 else sampler.sample_by_time(time_step)
        out = {key: triples[col].astype(np.int32) for key, col in (("users", "UID"), ("item1", "PID1"),
                                                                   ("item2", "PID2"))}
        if "T" in triples:
            out["t"] = triples["T"].astype(np.int32)
        return out

    def user_item_features(self, fea_type="random", emb_dim=64, item_fea_dic=None, seed=0):
        """(user features (n_users, emb_dim), item features) float32: standard
        normal draws from ``np.random.default_rng(seed)``, users first; with
        another ``fea_type`` and ``item_fea_dic``, the item features are that
        dict's matrices concatenated in key order."""
        rng = np.random.default_rng(seed)
        user_fea = rng.normal(0, 1, (self.n_users, emb_dim)).astype(np.float32)
        if fea_type == "random" or item_fea_dic is None:
            item_fea = rng.normal(0, 1, (self.n_items, emb_dim)).astype(np.float32)
        else:
            item_fea = np.concatenate([np.asarray(item_fea_dic[key], dtype=np.float32)
                                       for key in sorted(item_fea_dic)], axis=1)
        return user_fea, item_fea
