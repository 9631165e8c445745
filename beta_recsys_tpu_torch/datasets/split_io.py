"""Read-only loader of a saved train/valid/test split (numpy only).

Counterpart of ``load_split_data`` (``beta_recsys_tpu/datasets/data_split.py``)
and ``get_dataframe_from_npz`` (``beta_recsys_tpu/utils/common.py``). A frame
here is a dict of equal-length numpy columns keyed by the column names of
``utils.constants``, in place of a pandas DataFrame. This module never builds
or writes a split: the JAX package's pipeline does that.
"""

import os

import numpy as np

from ..utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_ORDER_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)

_NPZ_COLUMNS = {
    "user_ids": DEFAULT_USER_COL,
    "item_ids": DEFAULT_ITEM_COL,
    "ratings": DEFAULT_RATING_COL,
    "timestamps": DEFAULT_TIMESTAMP_COL,
    "order_ids": DEFAULT_ORDER_COL,
}


def read_frame(npz_path):
    """One split file -> {column name: numpy array}."""
    with np.load(npz_path, allow_pickle=False) as z:
        frame = {col: z[key] for key, col in _NPZ_COLUMNS.items() if key in z}
    for col in (DEFAULT_USER_COL, DEFAULT_ITEM_COL, DEFAULT_RATING_COL):
        if col not in frame:
            raise ValueError(f"{npz_path} has no {col} column")
    return frame


def load_split_data(path, n_test=10):
    """(train, valid, test) frames of a split directory.

    With ``n_test == 0`` the raw (negative-free) ``valid.npz``/``test.npz``;
    otherwise lists of the first ``n_test`` negative-sampled copies
    ``valid_{i}.npz``/``test_{i}.npz``.
    """
    train = read_frame(os.path.join(path, "train.npz"))
    if not n_test:
        return (train, read_frame(os.path.join(path, "valid.npz")),
                read_frame(os.path.join(path, "test.npz")))
    valid = [read_frame(os.path.join(path, f"valid_{i}.npz")) for i in range(n_test)]
    test = [read_frame(os.path.join(path, f"test_{i}.npz")) for i in range(n_test)]
    return train, valid, test
