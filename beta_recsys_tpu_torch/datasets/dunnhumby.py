"""Dunnhumby "The Complete Journey" adapter.

Counterpart of ``beta_recsys_tpu/datasets/dunnhumby.py``:
``transaction_data.csv``'s BASKET_ID, household_key, PRODUCT_ID, DAY and
TRANS_TIME columns (chosen by header name) become (order, user, item, rating
1, timestamp), the timestamp being the decimal string of DAY followed by
that of TRANS_TIME read as an int (DAY 1 at TRANS_TIME 5 is 15: no zero
padding).
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
from .raw_tables import read_table

DUNNHUMBY_URL = "https://www.dunnhumby.com/source-files/"


class Dunnhumby(DatasetBase):
    def __init__(self, dataset_name="dunnhumby", min_u_c=0, min_i_c=3, min_o_c=0, root_dir=None):
        super().__init__(
            dataset_name=dataset_name, min_u_c=min_u_c, min_i_c=min_i_c, min_o_c=min_o_c, root_dir=root_dir,
            url=DUNNHUMBY_URL,
            tips=("Dunnhumby requires manual download: place transaction_data.csv "
                  "(from 'The Complete Journey') under the raw directory."),
        )

    def preprocess(self):
        file_name = self.raw_file("transaction_data.csv", os.path.join("unzip", "transaction_data.csv"))
        tx = read_table(file_name, sep=",", header=0,
                        usecols=["BASKET_ID", "household_key", "PRODUCT_ID", "DAY", "TRANS_TIME"])
        time = np.char.add(tx["DAY"].astype(str), tx["TRANS_TIME"].astype(str)).astype(np.int64)
        data = {
            DEFAULT_ORDER_COL: tx["BASKET_ID"],
            DEFAULT_USER_COL: tx["household_key"],
            DEFAULT_ITEM_COL: tx["PRODUCT_ID"],
            DEFAULT_RATING_COL: np.ones(len(time)),
            DEFAULT_TIMESTAMP_COL: time,
        }
        self.save_dataframe_as_npz(data, self.interaction_file())
