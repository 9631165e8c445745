"""On-disk dataset lifecycle: preprocess -> k-core -> split -> cache.

Counterpart of ``beta_recsys_tpu/datasets/dataset_base.py``: a dataset lives
under ``<root>/datasets/<name>/{raw,processed}``; ``preprocess`` (per
adapter) writes the interaction npz; ``make_*`` builds each of the six splits
with its negative-sampled evaluation copies; ``load_*`` returns a cached
split, building it on a miss; ``load_split`` dispatches from a config. The
port downloads nothing: ``download()`` and ``download_processed_split()``
raise, and a split is built from the interactions on the host.
"""

import os

from ..utils.common import ensure_dir, get_dataframe_from_npz, save_dataframe_as_npz
from ..utils.constants import DEFAULT_ORDER_COL
from .data_split import (
    filter_user_item,
    filter_user_item_order,
    generate_parameterized_path,
    load_split_data,
    split_data,
)

default_root_dir = os.path.abspath(".")

SPLIT_ALIASES = {
    "random": "random_split",
    "random_basket": "random_basket_split",
    "temporal": "temporal_split",
    "temporal_basket": "temporal_basket_split",
    "random_split": "random_split",
    "random_basket_split": "random_basket_split",
    "temporal_split": "temporal_split",
    "temporal_basket_split": "temporal_basket_split",
    "leave_one_out": "leave_one_out",
    "leave_one_basket": "leave_one_basket",
}


class DatasetBase:
    """Base class of the dataset adapters."""

    def __init__(self, dataset_name, min_u_c=0, min_i_c=3, min_o_c=0, url=None, root_dir=None,
                 manual_download_url=None, tips=None, **processed_urls):
        self.dataset_name = dataset_name
        self.min_u_c, self.min_i_c, self.min_o_c = min_u_c, min_i_c, min_o_c
        self.url = url
        self.manual_download_url = manual_download_url or url
        self.processed_urls = processed_urls
        self.dataset_dir = os.path.join(root_dir or default_root_dir, "datasets", dataset_name)
        self.raw_path = os.path.join(self.dataset_dir, "raw")
        self.processed_path = os.path.join(self.dataset_dir, "processed")
        ensure_dir(self.raw_path)
        ensure_dir(self.processed_path)
        self.save_dataframe_as_npz = save_dataframe_as_npz
        self.tips = tips or (
            f"please download the dataset yourself via {self.manual_download_url}, "
            f"rename to {self.dataset_name} and put it into {self.raw_path} after decompression"
        )

    # -- raw data -----------------------------------------------------------------

    def download(self):
        """The port downloads nothing (its machines have no network)."""
        raise RuntimeError(f"beta_recsys_tpu_torch downloads no dataset: {self.tips}")

    def raw_file(self, *candidates):
        """The first of ``candidates`` (paths under ``raw_path``) that exists;
        with none, a ``RuntimeError`` naming them, ``raw_path`` and the tips."""
        for rel in candidates:
            path = os.path.join(self.raw_path, rel)
            if os.path.exists(path):
                return path
        raise RuntimeError(f"{self.dataset_name}: no {' or '.join(candidates)} under {self.raw_path} "
                           f"(beta_recsys_tpu_torch downloads nothing). {self.tips}")

    def preprocess(self):
        """Write the interaction npz from the raw files (per adapter)."""
        raise NotImplementedError

    def interaction_file(self):
        return os.path.join(self.processed_path, f"{self.dataset_name}_interaction.npz")

    def load_interaction(self):
        """The interaction frame (preprocessed on a miss), k-core filtered. A
        corrupted npz is rebuilt once by preprocessing again."""
        f = self.interaction_file()
        if not os.path.exists(f):
            self.preprocess()
        try:
            data = get_dataframe_from_npz(f)
        except Exception:
            print(f"[warn] corrupted interaction cache {f}; rebuilding")
            os.remove(f)
            self.preprocess()
            data = get_dataframe_from_npz(f)
        if DEFAULT_ORDER_COL in data and self.min_o_c > 0:
            data = filter_user_item_order(data, self.min_u_c, self.min_i_c, self.min_o_c)
        elif self.min_u_c > 0 or self.min_i_c > 0:
            data = filter_user_item(data, self.min_u_c, self.min_i_c)
        return data

    # -- split lifecycle ----------------------------------------------------------

    def _make_split(self, split_type, data=None, test_rate=0.1, random=False, n_negative=100, by_user=False,
                    n_test=10):
        if data is None:
            data = self.load_interaction()
        split_data(data, split_type=split_type, test_rate=test_rate, random=random, n_negative=n_negative,
                   save_dir=self.processed_path, by_user=by_user, n_test=n_test)

    def _load_split(self, split_type, test_rate=0.1, random=False, n_negative=100, by_user=False, n_test=10,
                    download=False):
        if n_negative < 0:
            n_test = 1  # all-negatives mode writes a single valid/test copy
        path = os.path.join(self.processed_path, split_type, generate_parameterized_path(
            test_rate=test_rate, random=random, n_negative=n_negative, by_user=by_user))
        if download and not os.path.exists(os.path.join(path, "train.npz")):
            self.download_processed_split(split_type, path)
        if not os.path.exists(os.path.join(path, "train.npz")):
            self._make_split(split_type, test_rate=test_rate, random=random, n_negative=n_negative,
                             by_user=by_user, n_test=n_test)
        return load_split_data(path, n_test=n_test)

    def download_processed_split(self, split_type, dest_dir):
        """The port downloads no published split."""
        raise RuntimeError(f"beta_recsys_tpu_torch downloads no processed split ({split_type}); "
                           f"set dataset.download false to build it from the interactions")

    def make_leave_one_out(self, data=None, random=False, n_negative=100, n_test=10):
        self._make_split("leave_one_out", data, 0, random, n_negative, False, n_test)

    def make_leave_one_basket(self, data=None, random=False, n_negative=100, n_test=10):
        self._make_split("leave_one_basket", data, 0, random, n_negative, False, n_test)

    def make_random_split(self, data=None, test_rate=0.1, by_user=False, n_negative=100, n_test=10):
        self._make_split("random", data, test_rate, False, n_negative, by_user, n_test)

    def make_random_basket_split(self, data=None, test_rate=0.1, by_user=False, n_negative=100, n_test=10):
        self._make_split("random_basket", data, test_rate, False, n_negative, by_user, n_test)

    def make_temporal_split(self, data=None, test_rate=0.1, by_user=False, n_negative=100, n_test=10):
        self._make_split("temporal", data, test_rate, False, n_negative, by_user, n_test)

    def make_temporal_basket_split(self, data=None, test_rate=0.1, by_user=False, n_negative=100, n_test=10):
        self._make_split("temporal_basket", data, test_rate, False, n_negative, by_user, n_test)

    def load_leave_one_out(self, random=False, n_negative=100, n_test=10, download=False):
        return self._load_split("leave_one_out", 0, random, n_negative, False, n_test, download)

    def load_leave_one_basket(self, random=False, n_negative=100, n_test=10, download=False):
        return self._load_split("leave_one_basket", 0, random, n_negative, False, n_test, download)

    def load_random_split(self, test_rate=0.1, by_user=False, n_negative=100, n_test=10, download=False):
        return self._load_split("random", test_rate, False, n_negative, by_user, n_test, download)

    def load_random_basket_split(self, test_rate=0.1, by_user=False, n_negative=100, n_test=10, download=False):
        return self._load_split("random_basket", test_rate, False, n_negative, by_user, n_test, download)

    def load_temporal_split(self, test_rate=0.1, by_user=False, n_negative=100, n_test=10, download=False):
        return self._load_split("temporal", test_rate, False, n_negative, by_user, n_test, download)

    def load_temporal_basket_split(self, test_rate=0.1, by_user=False, n_negative=100, n_test=10, download=False):
        return self._load_split("temporal_basket", test_rate, False, n_negative, by_user, n_test, download)

    def load_split(self, config):
        """The split a config names (a Config, a raw config dict, or its
        dataset section): every name of ``SPLIT_ALIASES``, the config's
        ``download`` flag, and ``n_negative < 0`` -> one valid/test copy."""
        if hasattr(config, "dataset") and not isinstance(config, dict):
            ds = config.dataset
        elif isinstance(config, dict) and isinstance(config.get("dataset"), dict):
            ds = config["dataset"]
        else:
            ds = config
        split = ds.get("data_split", "leave_one_out")
        if split not in SPLIT_ALIASES:
            raise KeyError(f"Unknown data_split {split!r}; accepted: {sorted(set(SPLIT_ALIASES))}")
        canonical = SPLIT_ALIASES[split]
        n_test = int(ds.get("n_test", 10))
        n_negative = int(ds.get("n_negative", 100))
        if n_negative < 0 and n_test > 1:
            n_test = 1
        kwargs = {"n_negative": n_negative, "n_test": n_test, "download": bool(ds.get("download", False))}
        if canonical in ("leave_one_out", "leave_one_basket"):
            kwargs["random"] = ds.get("random", False)
        else:
            kwargs["test_rate"] = ds.get("test_rate", 0.1)
            kwargs["by_user"] = ds.get("by_user", False)
        return getattr(self, f"load_{canonical}")(**kwargs)
