"""Single-file adapters: Epinions, last.fm, Gowalla, Taobao, Ali-Mobile,
RetailRocket, YooChoose, Diginetica, Yelp, CiteULike-a and CiteULike-t.

Counterpart of ``beta_recsys_tpu/datasets/simple_adapters.py``, column for
column and dtype for dtype, with one departure: the five date columns
(Gowalla, Ali-Mobile, YooChoose, Diginetica, Yelp) hold true epoch seconds.
The JAX adapters' ``pd.to_datetime(col).astype(np.int64) // 10**9`` reads
microseconds under pandas 3, which stores seconds // 1000 (ROADMAP.md, notes
on the reference).
"""

import json

import numpy as np

from ..utils.constants import DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_TIMESTAMP_COL, DEFAULT_USER_COL
from .dataset_base import DatasetBase
from .raw_tables import epoch_seconds, read_table

EPINIONS_URL = "http://www.trustlet.org/datasets/downloaded_epinions/ratings_data.txt.bz2"
LAST_FM_URL = "http://files.grouplens.org/datasets/hetrec2011/hetrec2011-lastfm-2k.zip"
GOWALLA_URL = "https://snap.stanford.edu/data/loc-gowalla_totalCheckins.txt.gz"
TAOBAO_URL = "https://tianchi.aliyun.com/dataset/dataDetail?dataId=649"
ALIMOBILE_URL = "https://tianchi.aliyun.com/dataset/dataDetail?dataId=46"
RETAIL_ROCKET_URL = "https://www.kaggle.com/retailrocket/ecommerce-dataset/download"
YOOCHOOSE_URL = "https://s3-eu-west-1.amazonaws.com/yc-rdata/yoochoose-data.7z"
DIGINETICA_URL = "https://cikm2016.cs.iupui.edu/cikm-cup/"
YELP_URL = "https://www.yelp.com/dataset"
CULA_URL = "https://github.com/js05212/citeulike-a"
CULT_URL = "https://github.com/js05212/citeulike-t"

U, I, R, T = DEFAULT_USER_COL, DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_TIMESTAMP_COL


class _SingleFile(DatasetBase):
    """One raw file read by ``read_table``; ``implicit`` adds rating 1 and
    ``dated`` parses the timestamp column into epoch seconds."""

    raw_name = None
    read_kwargs = {}
    implicit = False
    dated = False
    url = None
    default_tips = None

    def __init__(self, dataset_name=None, min_u_c=0, min_i_c=3, root_dir=None):
        super().__init__(dataset_name=dataset_name or self.default_name, min_u_c=min_u_c, min_i_c=min_i_c,
                         root_dir=root_dir, url=type(self).url, tips=self.default_tips)

    def read(self, file_name):
        return read_table(file_name, **self.read_kwargs)

    def preprocess(self):
        data = self.read(self.raw_file(self.raw_name))
        if self.implicit:
            data[R] = np.ones(len(data[U]))
        if self.dated:
            data[T] = epoch_seconds(data[T])
        self.save_dataframe_as_npz(data, self.interaction_file())


class Epinions(_SingleFile):
    """ratings_data.txt: space-separated (user, item, rating)."""

    default_name, raw_name, url = "epinions", "ratings_data.txt", EPINIONS_URL
    read_kwargs = {"sep": " ", "names": [U, I, R]}


class LastFM(_SingleFile):
    """hetrec2011-lastfm user_artists.dat: (user, artist, weight)."""

    default_name, raw_name, url = "last_fm", "user_artists.dat", LAST_FM_URL
    read_kwargs = {"sep": "\t", "header": 0, "names": [U, I, R]}


class Gowalla(_SingleFile):
    """loc-gowalla_totalCheckins.txt: tab-separated (user, time, lat, lon, location)."""

    default_name, raw_name, url = "gowalla", "loc-gowalla_totalCheckins.txt", GOWALLA_URL
    read_kwargs = {"sep": "\t", "usecols": [0, 1, 4], "names": [U, T, I]}
    implicit = dated = True


class Taobao(_SingleFile):
    """UserBehavior.csv: (user, item, category, behavior, timestamp)."""

    default_name, raw_name, url = "taobao", "UserBehavior.csv", TAOBAO_URL
    default_tips = "Taobao UserBehavior.csv requires manual download (tianchi)."
    read_kwargs = {"sep": ",", "usecols": [0, 1, 4], "names": [U, I, T]}
    implicit = True


class AliMobile(_SingleFile):
    """tianchi_mobile_recommend_train_user.csv: (user, item, ..., time)."""

    default_name, raw_name, url = "ali_mobile", "tianchi_mobile_recommend_train_user.csv", ALIMOBILE_URL
    default_tips = "Ali-Mobile requires manual download (tianchi)."
    read_kwargs = {"sep": ",", "header": 0, "usecols": [0, 1, 5], "names": [U, I, T]}
    implicit = dated = True


class RetailRocket(_SingleFile):
    """events.csv: (timestamp, visitorid, event, itemid, transactionid)."""

    default_name, raw_name, url = "retailrocket", "events.csv", RETAIL_ROCKET_URL
    default_tips = "RetailRocket events.csv requires manual download (kaggle)."
    read_kwargs = {"sep": ",", "header": 0, "usecols": [0, 1, 3], "names": [T, U, I]}
    implicit = True


class YooChoose(_SingleFile):
    """yoochoose-clicks.dat: (session, timestamp, item, category); sessions
    act as users."""

    default_name, raw_name, url = "yoochoose", "yoochoose-clicks.dat", YOOCHOOSE_URL
    read_kwargs = {"sep": ",", "usecols": [0, 1, 2], "names": [U, T, I]}
    implicit = dated = True


class Diginetica(_SingleFile):
    """train-item-views.csv (;-separated): (session, user, item, timeframe, eventdate)."""

    default_name, raw_name, url = "diginetica", "train-item-views.csv", DIGINETICA_URL
    default_tips = "Diginetica requires manual download (CIKM Cup 2016)."
    read_kwargs = {"sep": ";", "header": 0, "usecols": [0, 2, 4], "names": [U, I, T]}
    implicit = dated = True


class Yelp(_SingleFile):
    """yelp_academic_dataset_review.json: one review a line (user, business,
    stars, date)."""

    default_name, raw_name, url = "yelp", "yelp_academic_dataset_review.json", YELP_URL
    default_tips = "Yelp requires manual download of the academic dataset."
    dated = True

    def read(self, file_name):
        with open(file_name) as f:
            reviews = [json.loads(line) for line in f]
        return {U: np.array([r["user_id"] for r in reviews], dtype=object),
                I: np.array([r["business_id"] for r in reviews], dtype=object),
                R: np.array([float(r["stars"]) for r in reviews]),
                T: [r["date"] for r in reviews]}


class _CiteULikeBase(_SingleFile):
    """citeulike users.dat: line u holds user u's article ids, after a count
    where the line has more than one token."""

    raw_name = "users.dat"

    def read(self, file_name):
        users, items = [], []
        with open(file_name) as f:
            for u, line in enumerate(f):
                ids = line.split()
                arts = ids[1:] if len(ids) > 1 else ids
                users.extend([u] * len(arts))
                items.extend(int(a) for a in arts)
        return {U: np.array(users, dtype=np.int64), I: np.array(items, dtype=np.int64),
                R: np.ones(len(users)), T: np.zeros(len(users), dtype=np.int64)}


class CiteULikeA(_CiteULikeBase):
    default_name, url = "citeulike-a", CULA_URL


class CiteULikeT(_CiteULikeBase):
    default_name, url = "citeulike-t", CULT_URL
