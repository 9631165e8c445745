"""Dataset registry and config-driven loading (numpy only).

Counterpart of ``beta_recsys_tpu/datasets/data_load.py``: ``DATASET_REGISTRY``
maps every dataset name of the JAX package's registry to its adapter;
``load_split_dataset`` builds the adapter and loads the configured split,
building it on a miss (preprocess of the raw files, k-core, split; a missing
raw file raises a ``RuntimeError`` naming it and the raw directory);
``load_item_fea_dic`` / ``load_user_fea_dic`` read "id v1 v2 ..." feature
files and ``load_user_item_feature`` the processed feature npz.
"""

import os

import numpy as np

from . import amazon
from .amazon import AMAZON_CATEGORIES
from .dunnhumby import Dunnhumby
from .hetrec import Delicious_2k, LastFM_2k, MovieLens_2k
from .instacart import Instacart, Instacart_25
from .movielens import Movielens_1m, Movielens_10m, Movielens_25m, Movielens_100k
from .simple_adapters import (
    AliMobile,
    CiteULikeA,
    CiteULikeT,
    Diginetica,
    Epinions,
    Gowalla,
    LastFM,
    RetailRocket,
    Taobao,
    Yelp,
    YooChoose,
)
from .synthetic import Synthetic, SyntheticStructured
from .tafeng import Tafeng

DATASET_REGISTRY = {
    "synthetic": Synthetic,
    "synthetic_structured": SyntheticStructured,
    "random": Synthetic,
    "ml_100k": Movielens_100k,
    "ml_1m": Movielens_1m,
    "ml_10m": Movielens_10m,
    "ml_25m": Movielens_25m,
    "dunnhumby": Dunnhumby,
    "tafeng": Tafeng,
    "instacart": Instacart,
    "instacart_25": Instacart_25,
    "epinions": Epinions,
    "last_fm": LastFM,
    "yelp": Yelp,
    "gowalla": Gowalla,
    "taobao": Taobao,
    "ali_mobile": AliMobile,
    "retailrocket": RetailRocket,
    "yoochoose": YooChoose,
    "diginetica": Diginetica,
    "citeulike-a": CiteULikeA,
    "citeulike-t": CiteULikeT,
    "movielens_2k": MovieLens_2k,
    "delicious-2k": Delicious_2k,
    "lastfm-2k": LastFM_2k,
    **{f"amazon_{category.lower()}": getattr(amazon, name) for name, category in AMAZON_CATEGORIES.items()},
}


def _dataset_section(config):
    return config["dataset"] if isinstance(config.get("dataset"), dict) else config


def build_dataset(config):
    """The adapter named by ``config["dataset"]["dataset"]``."""
    ds_cfg = _dataset_section(config)
    name = ds_cfg["dataset"]
    if name not in DATASET_REGISTRY:
        raise KeyError(f"Unknown dataset {name!r}; known: {sorted(DATASET_REGISTRY)}")
    kwargs = {key: ds_cfg[key] for key in ("root_dir", "min_u_c", "min_i_c", "min_o_c") if key in ds_cfg}
    return DATASET_REGISTRY[name](**kwargs)


def load_split_dataset(config):
    """The configured dataset's split: (train, valid[s], test[s]) frames."""
    cfg = config if isinstance(config.get("dataset"), dict) else {"dataset": config}
    return build_dataset(config).load_split(cfg)


def _load_fea_dic(file_path):
    """'id v1 v2 ...' lines -> {id: float32 array}."""
    fea_dic = {}
    with open(file_path) as f:
        for line in f:
            parts = line.split()
            if parts:
                fea_dic[int(parts[0])] = np.asarray([float(x) for x in parts[1:]], dtype=np.float32)
    return fea_dic


def _raw_path(config, side, fea_type):
    ds_cfg = _dataset_section(config)
    return os.path.join(ds_cfg.get("root_dir", "."), "datasets", ds_cfg["dataset"], "raw", f"{side}_fea",
                        f"{fea_type}.csv")


def load_item_fea_dic(config, fea_type):
    """Item features of one type (``datasets/<name>/raw/item_fea/<type>.csv``)."""
    return _load_fea_dic(_raw_path(config, "item", fea_type))


def load_user_fea_dic(config, fea_type):
    """User features of one type (``datasets/<name>/raw/user_fea/<type>.csv``)."""
    return _load_fea_dic(_raw_path(config, "user", fea_type))


def load_user_item_feature(config):
    """(user_feat, item_feat) from ``datasets/<name>/processed/<name>_fea_vec.npz``."""
    ds_cfg = _dataset_section(config)
    name = ds_cfg["dataset"]
    with np.load(os.path.join(ds_cfg.get("root_dir", "."), "datasets", name, "processed",
                              f"{name}_fea_vec.npz")) as data:
        return data["user_feat"], data["item_feat"]
