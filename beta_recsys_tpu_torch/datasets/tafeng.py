"""Ta-Feng grocery adapter.

Counterpart of ``beta_recsys_tpu/datasets/tafeng.py``: each line of
``train.txt`` (and ``test.txt`` where present) is
``order_id<TAB>item...<TAB>user_id<TAB>date``, expanded into one implicit
interaction an item. The ids stay strings (an order id that is all digits is
stored as int64, as the npz codec stores any order column); the timestamp is
the date with its "-" removed, read as an int.
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
from .dataset_base import DatasetBase

TAFENG_URL = "https://www.kaggle.com/chiranjivdas09/ta-feng-grocery-dataset"


class Tafeng(DatasetBase):
    def __init__(self, dataset_name="tafeng", min_u_c=0, min_i_c=3, min_o_c=0, root_dir=None):
        super().__init__(dataset_name=dataset_name, min_u_c=min_u_c, min_i_c=min_i_c, min_o_c=min_o_c,
                         root_dir=root_dir, url=TAFENG_URL,
                         tips="Ta-Feng requires manual download (kaggle); place train.txt/test.txt in raw/.")

    @staticmethod
    def _parse(file_name):
        """(order, user, item, 1.0, date digits) rows, the JAX parser's: a
        line's last field before the newline is its date, the one before
        that its user."""
        rows = []
        with open(file_name) as f:
            for line in f:
                parts = line.replace("\n", "\t").split("\t")
                order_id, user_id, time_order = parts[0], parts[-3], parts[-2].replace("-", "")
                rows.extend((order_id, user_id, item_id, 1.0, time_order) for item_id in parts[1:-3])
        return rows

    def preprocess(self):
        rows = self._parse(self.raw_file("train.txt"))
        test_file = os.path.join(self.raw_path, "test.txt")
        if os.path.exists(test_file):
            rows += self._parse(test_file)
        arr = np.array(rows, dtype=object)
        data = {
            DEFAULT_ORDER_COL: arr[:, 0],
            DEFAULT_USER_COL: arr[:, 1],
            DEFAULT_ITEM_COL: arr[:, 2],
            DEFAULT_RATING_COL: arr[:, 3].astype(np.float32),
            DEFAULT_TIMESTAMP_COL: arr[:, 4].astype(np.int64),
        }
        self.save_dataframe_as_npz(data, self.interaction_file())
