"""HetRec 2011 adapters: MovieLens-2k, Delicious-2k and LastFM-2k.

Counterpart of ``beta_recsys_tpu/datasets/hetrec.py``: MovieLens-2k reads
``user_ratedmovies-timestamps.dat``; Delicious-2k
``user_taggedbookmarks-timestamps.dat`` (columns by position: user,
bookmark as the item, rating 1, and the timestamp as both the timestamp and
the order); LastFM-2k ``user_artists.dat`` with the row number as its
timestamp.
"""

import numpy as np

from ..utils.constants import (
    DEFAULT_ITEM_COL,
    DEFAULT_ORDER_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)
from .raw_tables import read_table
from .simple_adapters import _SingleFile

ML_2K_URL = "http://files.grouplens.org/datasets/hetrec2011/hetrec2011-movielens-2k-v2.zip"
DL_2K_URL = "http://files.grouplens.org/datasets/hetrec2011/hetrec2011-delicious-2k.zip"
LF_2K_URL = "http://files.grouplens.org/datasets/hetrec2011/hetrec2011-lastfm-2k.zip"

U, I, R, T = DEFAULT_USER_COL, DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_TIMESTAMP_COL


class MovieLens_2k(_SingleFile):
    default_name, raw_name, url = "movielens_2k", "user_ratedmovies-timestamps.dat", ML_2K_URL
    read_kwargs = {"sep": "\t", "header": 0, "names": [U, I, R, T]}


class Delicious_2k(_SingleFile):
    default_name, raw_name, url = "delicious-2k", "user_taggedbookmarks-timestamps.dat", DL_2K_URL

    def read(self, file_name):
        raw = list(read_table(file_name, sep="\t", header=0).values())
        return {U: raw[0], I: raw[1], R: np.ones(len(raw[0])), T: raw[3], DEFAULT_ORDER_COL: raw[3]}


class LastFM_2k(_SingleFile):
    default_name, raw_name, url = "lastfm-2k", "user_artists.dat", LF_2K_URL
    read_kwargs = {"sep": "\t", "header": 0, "names": [U, I, R]}

    def read(self, file_name):
        data = super().read(file_name)
        data[T] = np.arange(len(data[U]))
        return data
