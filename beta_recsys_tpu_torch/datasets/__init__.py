"""On-disk dataset layer: synthetic adapters, the k-core, splits, the cache."""

from .data_load import (  # noqa: F401
    DATASET_REGISTRY,
    build_dataset,
    load_item_fea_dic,
    load_split_dataset,
    load_user_fea_dic,
    load_user_item_feature,
)
from .data_split import (  # noqa: F401
    feed_neg_sample,
    filter_user_item,
    filter_user_item_order,
    generate_parameterized_path,
    generate_random_data,
    leave_one_basket,
    leave_one_out,
    load_split_data,
    random_basket_split,
    random_split,
    save_split_data,
    split_data,
    temporal_basket_split,
    temporal_split,
)
from .dataset_base import DatasetBase  # noqa: F401
