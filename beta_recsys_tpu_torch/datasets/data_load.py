"""Dataset registry and config-driven loading (numpy only).

Counterpart of ``beta_recsys_tpu/datasets/data_load.py``: ``DATASET_REGISTRY``
maps a config's dataset name to its adapter; ``load_split_dataset`` builds the
adapter and loads the configured split (building it on a miss);
``load_item_fea_dic`` / ``load_user_fea_dic`` read "id v1 v2 ..." feature
files and ``load_user_item_feature`` the processed feature npz. The port has
the synthetic adapters; every adapter that reads downloaded raw files is
registered under its JAX name and raises.
"""

import os

import numpy as np

from .synthetic import Synthetic, SyntheticStructured

_AMAZON_CATEGORIES = (
    "Amazon_Instant_Video", "Musical_Instruments", "Digital_Music", "Baby", "Patio_Lawn_and_Garden",
    "Grocery_and_Gourmet_Food", "Automotive", "Pet_Supplies", "Cell_Phones_and_Accessories",
    "Health_and_Personal_Care", "Toys_and_Games", "Video_Games", "Tools_and_Home_Improvement", "Beauty",
    "Apps_for_Android", "Office_Products", "Books", "Electronics", "Movies_and_TV", "CDs_and_Vinyl",
    "Clothing_Shoes_and_Jewelry", "Home_and_Kitchen", "Kindle_Store", "Sports_and_Outdoors",
)
RAW_FILE_ADAPTERS = (
    "ml_100k", "ml_1m", "ml_10m", "ml_25m", "dunnhumby", "tafeng", "instacart", "instacart_25", "epinions",
    "last_fm", "yelp", "gowalla", "taobao", "ali_mobile", "retailrocket", "yoochoose", "diginetica",
    "citeulike-a", "citeulike-t", "movielens_2k", "delicious-2k", "lastfm-2k",
    *(f"amazon_{category.lower()}" for category in _AMAZON_CATEGORIES),
)


def _raw_file_adapter(name):
    def adapter(**kwargs):
        raise NotImplementedError(
            f"dataset {name!r}: the adapters that preprocess raw files are ROADMAP.md, section 1 item 10; "
            "the port builds the synthetic datasets ('synthetic', 'synthetic_structured', 'random') and reads "
            "any split directory the JAX package wrote (datasets.data_split.load_split_data)")

    return adapter


DATASET_REGISTRY = {
    "synthetic": Synthetic,
    "synthetic_structured": SyntheticStructured,
    "random": Synthetic,
    **{name: _raw_file_adapter(name) for name in RAW_FILE_ADAPTERS},
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
