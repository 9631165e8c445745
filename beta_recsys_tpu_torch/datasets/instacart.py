"""Instacart market-basket adapter and its 25% user sample.

Counterpart of ``beta_recsys_tpu/datasets/instacart.py``: the prior and
train order products, joined to ``orders.csv`` on order_id (an inner join
in the order of the products' rows), become (user, order, item, rating 1,
timestamp = order_number). ``Instacart_25`` keeps the users that
``np.random.default_rng(0).choice`` draws, without replacement, from a
quarter of the users in order of first appearance: the JAX package's draw
(whose ``Instacart_25`` cannot be constructed; ROADMAP.md, notes on the
reference).
"""

import os

import numpy as np

from ..utils.common import inner_join_rows
from ..utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_ORDER_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)
from .data_split import first_unique
from .dataset_base import DatasetBase
from .raw_tables import read_table

INSTACART_URL = "https://www.kaggle.com/c/instacart-market-basket-analysis/data"


class Instacart(DatasetBase):
    sample_rate = 1.0

    def __init__(self, dataset_name="instacart", min_u_c=0, min_i_c=3, min_o_c=0, root_dir=None):
        super().__init__(
            dataset_name=dataset_name, min_u_c=min_u_c, min_i_c=min_i_c, min_o_c=min_o_c, root_dir=root_dir,
            url=INSTACART_URL,
            tips=("Instacart requires manual download (kaggle instacart-market-basket-analysis); "
                  "place order_products__prior.csv, order_products__train.csv, orders.csv in raw/."),
        )

    def preprocess(self):
        raw = os.path.dirname(self.raw_file("orders.csv", os.path.join("instacart", "orders.csv")))
        cols = ["order_id", "product_id", "add_to_cart_order"]
        prior = read_table(os.path.join(raw, "order_products__prior.csv"), sep=",", header=0, usecols=cols)
        train = read_table(os.path.join(raw, "order_products__train.csv"), sep=",", header=0, usecols=cols)
        products = {col: np.concatenate([prior[col], train[col]]) for col in cols}
        orders = read_table(os.path.join(raw, "orders.csv"), sep=",", header=0,
                            usecols=["user_id", "order_id", "order_number"])
        left, right = inner_join_rows([products["order_id"]], [orders["order_id"]])
        merged = {col: values[left] for col, values in products.items()}
        merged.update({col: orders[col][right] for col in ("user_id", "order_number")})
        if self.sample_rate < 1.0:
            users = first_unique(merged["user_id"])
            keep = np.random.default_rng(0).choice(users, size=int(len(users) * self.sample_rate), replace=False)
            rows = np.isin(merged["user_id"], keep)
            merged = {col: values[rows] for col, values in merged.items()}
        data = {
            DEFAULT_USER_COL: merged["user_id"],
            DEFAULT_ORDER_COL: merged["order_id"],
            DEFAULT_ITEM_COL: merged["product_id"],
            DEFAULT_RATING_COL: np.ones(len(merged["user_id"])),
            DEFAULT_TIMESTAMP_COL: merged["order_number"],
        }
        self.save_dataframe_as_npz(data, self.interaction_file())


class Instacart_25(Instacart):
    """A 25% user sample of Instacart."""

    sample_rate = 0.25

    def __init__(self, dataset_name="instacart_25", min_u_c=0, min_i_c=3, min_o_c=0, root_dir=None):
        super().__init__(dataset_name=dataset_name, min_u_c=min_u_c, min_i_c=min_i_c, min_o_c=min_o_c,
                         root_dir=root_dir)
