"""Amazon review adapters (SNAP per-category review dumps).

Counterpart of ``beta_recsys_tpu/datasets/amazon.py``: each category's
``reviews_<Category>.json.gz`` holds one review a line; (reviewerID, asin,
overall, unixReviewTime) become the interactions, the ids as strings
(fixed-width unicode in the npz) and the timestamp 0 where
``unixReviewTime`` is missing. ``AmazonDataset`` is the base, and
one class a category of ``AMAZON_CATEGORIES`` is generated from it.
"""

import gzip
import json

import numpy as np

from ..utils.constants import DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_TIMESTAMP_COL, DEFAULT_USER_COL
from .dataset_base import DatasetBase

_SNAP = "http://snap.stanford.edu/data/amazon/productGraph/categoryFiles"

# class name -> the category in the raw file's name
AMAZON_CATEGORIES = {
    "AmazonInstantVideo": "Amazon_Instant_Video",
    "AmazonMusicalInstruments": "Musical_Instruments",
    "AmazonDigitalMusic": "Digital_Music",
    "AmazonBaby": "Baby",
    "AmazonPatioLawnGarden": "Patio_Lawn_and_Garden",
    "AmazonGroceryGourmetFood": "Grocery_and_Gourmet_Food",
    "AmazonAutomotive": "Automotive",
    "AmazonPetSupplies": "Pet_Supplies",
    "AmazonCellPhonesAndAccessories": "Cell_Phones_and_Accessories",
    "AmazonHealthAndPersonalCare": "Health_and_Personal_Care",
    "AmazonToysAndGames": "Toys_and_Games",
    "AmazonVideoGames": "Video_Games",
    "AmazonToolsAndHomeImprovement": "Tools_and_Home_Improvement",
    "AmazonBeauty": "Beauty",
    "AmazonAppsForAndroid": "Apps_for_Android",
    "AmazonOfficeProducts": "Office_Products",
    "AmazonBooks": "Books",
    "AmazonElectronics": "Electronics",
    "AmazonMoviesAndTV": "Movies_and_TV",
    "AmazonCDsAndVinyl": "CDs_and_Vinyl",
    "AmazonClothingShoesAndJewelry": "Clothing_Shoes_and_Jewelry",
    "AmazonHomeAndKitchen": "Home_and_Kitchen",
    "AmazonKindleStore": "Kindle_Store",
    "AmazonSportsAndOutdoors": "Sports_and_Outdoors",
}


class AmazonDataset(DatasetBase):
    """One category's reviews; a subclass sets ``category``."""

    category = None  # e.g. "Digital_Music"

    def __init__(self, dataset_name=None, min_u_c=0, min_i_c=3, root_dir=None):
        super().__init__(dataset_name=dataset_name or f"amazon_{self.category.lower()}", min_u_c=min_u_c,
                         min_i_c=min_i_c, root_dir=root_dir, url=f"{_SNAP}/reviews_{self.category}.json.gz")

    def preprocess(self):
        with gzip.open(self.raw_file(f"reviews_{self.category}.json.gz"), "rt") as f:
            reviews = [json.loads(line) for line in f]
        data = {
            DEFAULT_USER_COL: np.array([r["reviewerID"] for r in reviews], dtype=object),
            DEFAULT_ITEM_COL: np.array([r["asin"] for r in reviews], dtype=object),
            DEFAULT_RATING_COL: np.array([float(r["overall"]) for r in reviews]),
            DEFAULT_TIMESTAMP_COL: np.array([int(r.get("unixReviewTime", 0)) for r in reviews], dtype=np.int64),
        }
        self.save_dataframe_as_npz(data, self.interaction_file())


for _name, _category in AMAZON_CATEGORIES.items():
    globals()[_name] = type(_name, (AmazonDataset,), {"category": _category, "__doc__": f"Amazon {_category} reviews."})

__all__ = ["AMAZON_CATEGORIES", "AmazonDataset", *AMAZON_CATEGORIES]
