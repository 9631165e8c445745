"""Canonical column names and framework-wide constants.

Mirrors the reference contract (reference: beta_rec/utils/constants.py:1-28) so that
split caches and result CSVs are interchangeable with the reference framework.
"""

DEFAULT_USER_COL = "col_user"
DEFAULT_ITEM_COL = "col_item"
DEFAULT_RATING_COL = "col_rating"
DEFAULT_LABEL_COL = "col_label"
DEFAULT_ORDER_COL = "col_order"
DEFAULT_FLAG_COL = "col_flag"
DEFAULT_TIMESTAMP_COL = "col_timestamp"
DEFAULT_PREDICTION_COL = "col_prediction"

DEFAULT_K = 10
DEFAULT_THRESHOLD = 10
MAX_N_UPDATE = 5  # early-stop criterion: max number of epochs without improvement

# Datasets with implicit feedback only (every interaction scored 1).
IMPLICIT_DATASETS = [
    "ali_mobile",
    "citeulike-a",
    "citeulike-t",
    "diginetica",
    "dunnhumby",
    "gowalla",
    "delicious-2k",
    "lastfm-2k",
    "retailrocket",
    "tafeng",
    "taobao",
    "yoochoose",
]
