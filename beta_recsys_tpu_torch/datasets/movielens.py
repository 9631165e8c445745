"""MovieLens adapters (100k, 1m, 10m, 25m) and ml-100k's feature vectors.

Counterpart of ``beta_recsys_tpu/datasets/movielens.py``: the rating file
(``u.data`` tab-separated, ``ratings.dat`` "::"-separated, ``ratings.csv``
with a header) becomes the interaction npz with the JAX package's columns
and dtypes (int64 ids and timestamps; ratings float32 in the npz).
``Movielens_100k.make_fea_vec`` builds the one-hot user features (the id,
8 age buckets, gender, occupations in sorted order) and the 19-genre item
features. The port downloads nothing: a missing file raises with the tips.
"""

import os

import numpy as np

from ..utils.common import savez_compressed
from ..utils.constants import DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_TIMESTAMP_COL, DEFAULT_USER_COL
from .dataset_base import DatasetBase
from .raw_tables import read_table

ML_100K_URL = "http://files.grouplens.org/datasets/movielens/ml-100k.zip"
ML_1M_URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"
ML_10M_URL = "http://files.grouplens.org/datasets/movielens/ml-10m.zip"
ML_25M_URL = "http://files.grouplens.org/datasets/movielens/ml-25m.zip"

_COLS = [DEFAULT_USER_COL, DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_TIMESTAMP_COL]


class Movielens_100k(DatasetBase):
    """MovieLens-100k: ``u.data``, tab-separated (user, item, rating, timestamp)."""

    def __init__(self, dataset_name="ml_100k", min_u_c=0, min_i_c=3, root_dir=None):
        super().__init__(dataset_name=dataset_name, min_u_c=min_u_c, min_i_c=min_i_c, root_dir=root_dir,
                         url=ML_100K_URL)

    def preprocess(self):
        file_name = self.raw_file(os.path.join(self.dataset_name, "u.data"), os.path.join("ml-100k", "u.data"))
        self.save_dataframe_as_npz(read_table(file_name, sep="\t", names=_COLS), self.interaction_file())

    def make_fea_vec(self):
        """(user_feat, item_feat), also written to
        ``processed/<name>_fea_vec.npz``: user_feat is float64 [id, 8 age
        buckets (min(age // 10, 7)), gender (F, M), one column an occupation
        in sorted order]; item_feat is ``u.item``'s id and 19 genre flags."""
        base = os.path.join(self.raw_path, self.dataset_name)
        if not os.path.isdir(base):
            base = os.path.join(self.raw_path, "ml-100k")
        item_raw = read_table(os.path.join(base, "u.item"), sep="|", encoding="latin-1")
        item_feat = np.stack([item_raw[c] for c in [0, *range(5, 24)]], axis=1)

        user_raw = read_table(os.path.join(base, "u.user"), sep="|")
        ages = np.minimum(user_raw[1] // 10, 7)
        gender = (user_raw[2] == "M").astype(int)
        _, occupations = np.unique(user_raw[3].astype(str), return_inverse=True)  # pd.Categorical's codes
        user_feat = np.concatenate([user_raw[0][:, None], np.eye(8)[ages], np.eye(2)[gender],
                                    np.eye(occupations.max() + 1)[occupations]], axis=1)
        savez_compressed(os.path.join(self.processed_path, f"{self.dataset_name}_fea_vec.npz"),
                         user_feat=user_feat, item_feat=item_feat)
        return user_feat, item_feat


class Movielens_1m(DatasetBase):
    """MovieLens-1M: ``ratings.dat``, "::"-separated."""

    subdirs = ("ml-1m",)

    def __init__(self, dataset_name="ml_1m", min_u_c=0, min_i_c=3, root_dir=None, url=ML_1M_URL):
        super().__init__(dataset_name=dataset_name, min_u_c=min_u_c, min_i_c=min_i_c, root_dir=root_dir, url=url)

    def preprocess(self):
        file_name = self.raw_file(*(os.path.join(sub, "ratings.dat") for sub in (self.dataset_name, *self.subdirs)))
        self.save_dataframe_as_npz(read_table(file_name, sep="::", names=_COLS), self.interaction_file())


class Movielens_10m(Movielens_1m):
    """MovieLens-10M: ``ratings.dat``, "::"-separated."""

    subdirs = ("ml-10M100K", "ml-10m")

    def __init__(self, dataset_name="ml_10m", min_u_c=0, min_i_c=3, root_dir=None):
        super().__init__(dataset_name=dataset_name, min_u_c=min_u_c, min_i_c=min_i_c, root_dir=root_dir,
                         url=ML_10M_URL)


class Movielens_25m(DatasetBase):
    """MovieLens-25M: ``ratings.csv`` with a header."""

    def __init__(self, dataset_name="ml_25m", min_u_c=0, min_i_c=3, root_dir=None):
        super().__init__(dataset_name=dataset_name, min_u_c=min_u_c, min_i_c=min_i_c, root_dir=root_dir,
                         url=ML_25M_URL)

    def preprocess(self):
        file_name = self.raw_file(*(os.path.join(sub, "ratings.csv") for sub in (self.dataset_name, "ml-25m")))
        self.save_dataframe_as_npz(read_table(file_name, sep=",", header=0, names=_COLS), self.interaction_file())
