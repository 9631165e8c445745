"""The port's raw-file dataset adapters against the JAX package's.

Each raw format is written with the standard library into one directory a
package; both adapters preprocess their copy and the interaction npz files
must hold the same arrays (names, dtypes, values). The one departure is the
five date-parsed timestamp columns (Gowalla, Ali-Mobile, YooChoose,
Diginetica, Yelp): the port's hold true epoch seconds, held to
``calendar.timegm``, and the JAX package's (seconds // 1000 under pandas 3)
are not compared. The shipped configs' splits (ml_100k leave_one_out,
dunnhumby leave_one_basket, tafeng leave_one_out) and their ``BaseData``
arrays are held to the JAX package's too.
"""

import calendar
import gzip
import json
import os
import time

import numpy as np
import pytest

from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.datasets import DATASET_REGISTRY as JAX_REGISTRY
from beta_recsys_tpu.datasets import amazon as jax_amazon
from beta_recsys_tpu.datasets import load_split_dataset as jax_load_split_dataset
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.datasets.instacart import Instacart as JaxInstacart
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.datasets import DATASET_REGISTRY, amazon, load_split_dataset
from beta_recsys_tpu_torch.datasets.raw_tables import epoch_seconds, read_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATED = {"gowalla", "ali_mobile", "yoochoose", "diginetica", "yelp"}


def write(path, text, encoding="utf-8"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding=encoding, newline="") as f:
        f.write(text)


def lines(rows, sep):
    return "".join(sep.join(str(x) for x in row) + "\n" for row in rows)


def seconds(text, fmt):
    return calendar.timegm(time.strptime(text, fmt))


# -- raw files, one writer a dataset (each takes the adapter's raw path) ----------------

def ml_100k_files(raw, sub="ml_100k", n_users=12, n_items=9, per_user=6, seed=0):
    rng = np.random.default_rng(seed)
    rows = [(u, i, int(rng.integers(1, 6)), 874724710 + int(rng.integers(0, 10**6)))
            for u in range(1, n_users + 1) for i in rng.choice(np.arange(1, n_items + 1), per_user, replace=False)]
    write(os.path.join(raw, sub, "u.data"), lines(rows, "\t"))
    genres = lambda i: [int((i >> g) & 1) for g in range(19)]  # noqa: E731
    items = [[i, f"Café {i} (1995)", "01-Jan-1995", "", f"http://x/{i}", *genres(i)] for i in range(1, n_items + 1)]
    write(os.path.join(raw, sub, "u.item"), lines(items, "|"), encoding="latin-1")
    occupations = ["writer", "artist", "technician", "writer", "educator", "artist"]  # not sorted
    users = [[u, 15 + 7 * u, "MF"[u % 2], occupations[u % len(occupations)], f"{u:05d}"]
             for u in range(1, n_users + 1)]
    write(os.path.join(raw, sub, "u.user"), lines(users, "|"))


def ml_1m_files(raw, sub="ml-1m", name="ratings.dat"):
    write(os.path.join(raw, sub, name),
          lines([(u, i, 1 + (u * i) % 5, 978300760 + u * 7 + i) for u in range(1, 5) for i in (3, 10, 7)], "::"))


def ml_25m_files(raw):
    write(os.path.join(raw, "ml-25m", "ratings.csv"), "userId,movieId,rating,timestamp\n"
          + lines([(u, i, f"{0.5 + (u + i) % 10 / 2}", 1147880044 + u + i) for u in range(1, 5) for i in (1, 29)], ","))


DUNNHUMBY_HEADER = ["household_key", "BASKET_ID", "DAY", "PRODUCT_ID", "QUANTITY", "SALES_VALUE", "STORE_ID",
                    "RETAIL_DISC", "TRANS_TIME", "WEEK_NO", "COUPON_DISC", "COUPON_MATCH_DISC"]


def dunnhumby_rows(n_households=30, baskets=6, seed=0):
    """transaction_data.csv rows: un-padded TRANS_TIME (5, 45, 931, 1631)."""
    rng = np.random.default_rng(seed)
    rows, basket = [], 26984851472
    for h in range(1, n_households + 1):
        for b in range(baskets):
            basket += int(rng.integers(1, 50))
            day, trans_time = 1 + 7 * b + h % 7, int(rng.choice([5, 45, 931, 1631, 2359]))
            for product in rng.choice(np.arange(1000, 1200), int(rng.integers(2, 7)), replace=False):
                rows.append([h, basket, day, int(product), 1, "1.39", 364, "-0.6", trans_time, 1 + day // 7, "0",
                             "0"])
    return rows


def dunnhumby_files(raw, n_households=30, seed=0):
    write(os.path.join(raw, "transaction_data.csv"),
          lines([DUNNHUMBY_HEADER] + dunnhumby_rows(n_households, seed=seed), ","))


def tafeng_files(raw, n_users=40, seed=0, digit_orders=False):
    """train.txt and test.txt: string ids, dates with "-"."""
    rng = np.random.default_rng(seed)
    out = {"train.txt": [], "test.txt": []}
    for u in range(n_users):
        for b in range(5):
            order = f"{u * 10 + b}" if digit_orders else f"o{u}_{b}"
            items = [f"47{int(i):08d}" for i in rng.choice(150, int(rng.integers(1, 5)), replace=False)]
            date = f"2001-{1 + b:02d}-{1 + u % 28:02d}"
            out["test.txt" if b == 4 else "train.txt"].append("\t".join([order, *items, f"u{u:05d}", date]) + "\n")
    for name, text in out.items():
        write(os.path.join(raw, name), "".join(text))


def instacart_files(raw, n_users=40, seed=0):
    """Order products whose orders come out of order, one order missing from
    orders.csv (the inner join drops its products)."""
    rng = np.random.default_rng(seed)
    orders, prior, train = [], [], []
    order_ids = rng.permutation(np.arange(100, 100 + 4 * n_users))
    for k, order_id in enumerate(order_ids):
        orders.append((int(rng.integers(1, n_users + 1)), int(order_id), 1 + k % 7))
    for order_id in rng.permutation(order_ids):
        target = train if order_id % 5 == 0 else prior
        for pos, product in enumerate(rng.choice(60, int(rng.integers(1, 5)), replace=False)):
            target.append((int(order_id), int(product), pos + 1, int(rng.integers(0, 2))))
    prior.append((99, 3, 1, 0))  # no such order
    write(os.path.join(raw, "orders.csv"), "order_id,user_id,eval_set,order_number,order_dow\n"
          + lines([(o, u, "prior", n, 3) for u, o, n in orders], ","))
    for name, rows in (("order_products__prior.csv", prior), ("order_products__train.csv", train)):
        write(os.path.join(raw, name), "order_id,product_id,add_to_cart_order,reordered\n" + lines(rows, ","))


GOWALLA = [(0, "2010-10-19T23:55:27Z", "30.2", "-97.7", 22847), (0, "2010-10-18T22:17:43Z", "30.3", "-97.8", 420315),
           (7, "2009-02-04T05:17:38Z", "30.2", "-97.7", 22847)]
ALI = [(10001082, 285259775, 1, "97lk14c", 4076, "2014-12-08 18"), (10001082, 4368907, 1, "", 5503, "2014-12-12 12"),
       (100029775, 285259775, 4, "", 4076, "2014-11-26 02")]
YOOCHOOSE = [(1, "2014-04-07T10:51:09.277Z", 214536502, 0), (1, "2014-04-07T10:54:09.868Z", 214536500, 0),
             (2, "2014-04-07T13:56:37.614Z", 214662742, "S")]
DIGINETICA = [(1, "", 81766, 526309, "2016-05-09"), (1, "", 31331, 1031018, "2016-05-09"),
              (2, "5678", 32118, 243569, "2016-05-10")]
YELP = [("u_-x1", "b1", 4.0, "2018-07-07 22:09:11"), ("u2", "b_2", 1.0, "2012-01-03 15:28:18"),
        ("u_-x1", "b_2", 5.0, "2014-02-05 20:30:30")]

RAW_WRITERS = {
    "ml_100k": ml_100k_files,
    "ml_1m": ml_1m_files,
    "ml_10m": lambda raw: ml_1m_files(raw, "ml-10M100K"),
    "ml_25m": ml_25m_files,
    "dunnhumby": dunnhumby_files,
    "tafeng": tafeng_files,
    "instacart": instacart_files,
    "epinions": lambda raw: write(os.path.join(raw, "ratings_data.txt"), "1 2 5\n3 4 1\n\n1 4 3\n"),
    "last_fm": lambda raw: write(os.path.join(raw, "user_artists.dat"),
                                 "userID\tartistID\tweight\n2\t51\t13883\n2\t52\t11690\n4\t51\t20\n"),
    "gowalla": lambda raw: write(os.path.join(raw, "loc-gowalla_totalCheckins.txt"), lines(GOWALLA, "\t")),
    "taobao": lambda raw: write(os.path.join(raw, "UserBehavior.csv"),
                                "1,2268318,2520377,pv,1511544070\n1,2333346,2520771,buy,1511561733\n"
                                "7,2268318,9,fav,1\n"),
    "ali_mobile": lambda raw: write(os.path.join(raw, "tianchi_mobile_recommend_train_user.csv"),
                                    "user_id,item_id,behavior_type,user_geohash,item_category,time\n"
                                    + lines(ALI, ",")),
    "retailrocket": lambda raw: write(os.path.join(raw, "events.csv"),
                                      "timestamp,visitorid,event,itemid,transactionid\n"
                                      "1433221332117,257597,view,355908,\n1433224214164,992329,view,248676,\n"
                                      "1433221999827,257597,transaction,355908,4000\n"),
    "yoochoose": lambda raw: write(os.path.join(raw, "yoochoose-clicks.dat"), lines(YOOCHOOSE, ",")),
    "diginetica": lambda raw: write(os.path.join(raw, "train-item-views.csv"),
                                    "sessionId;userId;itemId;timeframe;eventdate\n" + lines(DIGINETICA, ";")),
    "yelp": lambda raw: write(os.path.join(raw, "yelp_academic_dataset_review.json"), "".join(
        json.dumps({"review_id": f"r{k}", "user_id": u, "business_id": b, "stars": s, "date": d}) + "\n"
        for k, (u, b, s, d) in enumerate(YELP))),
    # a count first, a lone id, and two ids without a count (the first read as one)
    "citeulike-a": lambda raw: write(os.path.join(raw, "users.dat"), "3 10 11 12\n1 13\n7\n\n10 13\n"),
    "citeulike-t": lambda raw: write(os.path.join(raw, "users.dat"), "2 5 6\n9\n3 5 7 8\n"),
    "movielens_2k": lambda raw: write(os.path.join(raw, "user_ratedmovies-timestamps.dat"),
                                      "userID\tmovieID\trating\ttimestamp\n75\t3\t1\t1162160236000\n"
                                      "75\t32\t4.5\t1162160624000\n78\t3\t3.5\t1162160000000\n"),
    "delicious-2k": lambda raw: write(os.path.join(raw, "user_taggedbookmarks-timestamps.dat"),
                                      "userID\tbookmarkID\ttagID\ttimestamp\n8\t1\t1\t1289255362000\n"
                                      "8\t2\t1\t1289255159000\n9\t1\t4\t1289238901000\n"),
    "lastfm-2k": lambda raw: write(os.path.join(raw, "user_artists.dat"),
                                   "userID\tartistID\tweight\n2\t51\t13883\n2\t52\t11690\n3\t51\t7\n"),
}
EXPECTED_SECONDS = {
    "gowalla": [seconds(r[1], "%Y-%m-%dT%H:%M:%SZ") for r in GOWALLA],
    "ali_mobile": [seconds(r[5], "%Y-%m-%d %H") for r in ALI],
    "yoochoose": [seconds(r[1][:19], "%Y-%m-%dT%H:%M:%S") for r in YOOCHOOSE],
    "diginetica": [seconds(r[4], "%Y-%m-%d") for r in DIGINETICA],
    "yelp": [seconds(r[3], "%Y-%m-%d %H:%M:%S") for r in YELP],
}


def amazon_writer(category):
    """reviews_<Category>.json.gz: string ids (some all digits), a review
    without unixReviewTime."""
    def writer(raw):
        reviews = [{"reviewerID": "A2SUAM1J3GNN3B", "asin": "0000013714", "overall": 5.0,
                    "unixReviewTime": 1393545600},
                   {"reviewerID": "A14VAT5EAX3D9S", "asin": "B00004Y2UT", "overall": 3.0},
                   {"reviewerID": "A2SUAM1J3GNN3B", "asin": "B00004Y2UT", "overall": 4.0, "unixReviewTime": 1363392000}]
        os.makedirs(raw, exist_ok=True)
        with gzip.open(os.path.join(raw, f"reviews_{category}.json.gz"), "wt") as f:
            f.write("".join(json.dumps(r) + "\n" for r in reviews))
    return writer


def both(tmp_path, name, writer, jax_dataset=None):
    """The JAX and the port adapter, each with the raw files written into
    its own directory and preprocessed; their interaction npz paths."""
    jax_ds = jax_dataset(str(tmp_path / "jax")) if jax_dataset else JAX_REGISTRY[name](root_dir=str(tmp_path / "jax"))
    port_ds = DATASET_REGISTRY[name](root_dir=str(tmp_path / "port"))
    for ds in (jax_ds, port_ds):
        writer(ds.raw_path)
        ds.preprocess()
    return jax_ds.interaction_file(), port_ds.interaction_file()


def same_npz(want_path, got_path, skip=()):
    with np.load(want_path) as want, np.load(got_path) as got:
        assert sorted(got.keys()) == sorted(want.keys())
        for key in want:
            if key in skip:
                continue
            assert got[key].dtype == want[key].dtype, (key, got[key].dtype, want[key].dtype)
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(RAW_WRITERS))
def test_interaction_npz_equals_jax(tmp_path, name):
    want, got = both(tmp_path, name, RAW_WRITERS[name])
    same_npz(want, got, skip={"timestamps"} if name in DATED else ())
    if name in DATED:
        with np.load(got) as z:
            assert z["timestamps"].dtype == np.int64
            np.testing.assert_array_equal(z["timestamps"], EXPECTED_SECONDS[name])


@pytest.mark.parametrize("name", sorted(amazon.AMAZON_CATEGORIES))
def test_amazon_category_equals_jax(tmp_path, name):
    category = amazon.AMAZON_CATEGORIES[name]
    key = f"amazon_{category.lower()}"
    assert DATASET_REGISTRY[key] is getattr(amazon, name) and JAX_REGISTRY[key] is getattr(jax_amazon, name)
    want, got = both(tmp_path, key, amazon_writer(category))
    same_npz(want, got)
    with np.load(got) as z:
        assert z["user_ids"].dtype.kind == "U" and z["item_ids"][0] == "0000013714"
        np.testing.assert_array_equal(z["timestamps"], [1393545600, 0, 1363392000])


def test_instacart_25_equals_the_jax_sample(tmp_path):
    """The JAX Instacart_25 cannot be constructed (a TypeError); its draw is
    held through a JAX Instacart whose sample_rate is 0.25."""
    with pytest.raises(TypeError):
        JAX_REGISTRY["instacart_25"](root_dir=str(tmp_path / "broken"))

    def jax_quarter(root):
        ds = JaxInstacart(root_dir=root)
        ds.sample_rate = 0.25
        return ds

    want, got = both(tmp_path, "instacart_25", lambda raw: instacart_files(raw, n_users=80), jax_quarter)
    same_npz(want, got)
    with np.load(got) as z, np.load(want) as full_jax:
        assert 0 < len(np.unique(z["user_ids"])) <= 20 and len(full_jax["user_ids"]) > 0


@pytest.mark.parametrize("variant", ["ml_100k_alt_dir", "tafeng_digit_orders", "dunnhumby_unzip_dir"])
def test_alternative_layouts_equal_jax(tmp_path, variant):
    name, writer = {
        "ml_100k_alt_dir": ("ml_100k", lambda raw: ml_100k_files(raw, sub="ml-100k")),
        "tafeng_digit_orders": ("tafeng", lambda raw: tafeng_files(raw, digit_orders=True)),
        "dunnhumby_unzip_dir": ("dunnhumby", lambda raw: dunnhumby_files(os.path.join(raw, "unzip"))),
    }[variant]
    want, got = both(tmp_path, name, writer)
    same_npz(want, got)
    if variant == "tafeng_digit_orders":
        with np.load(got) as z:
            assert z["order_ids"].dtype == np.int64 and z["user_ids"].dtype.kind == "U"


def test_dunnhumby_timestamp_is_day_then_time_unpadded(tmp_path):
    _, got = both(tmp_path, "dunnhumby", dunnhumby_files)
    rows = dunnhumby_rows()
    with np.load(got) as z:
        np.testing.assert_array_equal(z["timestamps"], [int(f"{r[2]}{r[8]}") for r in rows])
        np.testing.assert_array_equal(z["order_ids"], [r[1] for r in rows])


def test_make_fea_vec_equals_jax(tmp_path):
    jax_ds = JAX_REGISTRY["ml_100k"](root_dir=str(tmp_path / "jax"))
    port_ds = DATASET_REGISTRY["ml_100k"](root_dir=str(tmp_path / "port"))
    for ds in (jax_ds, port_ds):
        ml_100k_files(ds.raw_path)
    want, got = jax_ds.make_fea_vec(), port_ds.make_fea_vec()
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # occupations by sorted name: artist, educator, technician, writer
    assert got[0].shape == (12, 1 + 8 + 2 + 4)
    np.testing.assert_array_equal(got[0][0, 11:], [1, 0, 0, 0])  # user 1 is an artist
    np.testing.assert_array_equal(got[0][1, 11:], [0, 0, 1, 0])  # user 2 a technician
    same_npz(os.path.join(jax_ds.processed_path, "ml_100k_fea_vec.npz"),
             os.path.join(port_ds.processed_path, "ml_100k_fea_vec.npz"))


@pytest.mark.parametrize("name", ["ml_100k", "tafeng", "instacart", "citeulike-a", "amazon_beauty", "yelp"])
def test_a_missing_raw_file_names_it_and_the_raw_path(tmp_path, name):
    ds = DATASET_REGISTRY[name](root_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="downloads nothing") as err:
        ds.preprocess()
    assert ds.raw_path in str(err.value) and ds.tips in str(err.value)


def test_the_registries_have_the_same_keys():
    assert sorted(DATASET_REGISTRY) == sorted(JAX_REGISTRY)
    for name, cls in DATASET_REGISTRY.items():
        assert isinstance(cls, type) and cls.__name__ == JAX_REGISTRY[name].__name__, name


SHIPPED_SPLITS = {  # dataset -> (shipped config, raw writer at a size with 100 negatives to draw)
    "ml_100k": ("configs/mf_default.json", lambda raw: ml_100k_files(raw, n_users=40, n_items=200, per_user=30)),
    "dunnhumby": ("configs/triple2vec_default.json", lambda raw: dunnhumby_files(raw, n_households=40)),
    "tafeng": ("configs/ultragcn_default.json", lambda raw: tafeng_files(raw, n_users=80)),
}


def _shipped(name, root):
    with open(os.path.join(REPO, SHIPPED_SPLITS[name][0])) as f:
        section = json.load(f)["dataset"]
    assert section["dataset"] == name
    return {"dataset": {**section, "root_dir": str(root)}}


def _columns(frame):
    return {col: np.asarray(frame[col]) for col in frame}


@pytest.mark.parametrize("name", sorted(SHIPPED_SPLITS))
def test_shipped_config_split_equals_jax(tmp_path, name):
    """load_split_dataset from the raw files (preprocess, k-core, the
    config's split, 10 copies of 100 negatives): every split file and the
    BaseData arrays, array for array. Ta-Feng's item ids are strings: the
    JAX package's negative-sampled copies hold them as int64 (its draw casts
    the ids), so JAX BaseData keeps none of their rows; the port's hold the
    same ids as strings, and its BaseData is held to JAX BaseData over the
    port's files."""
    writer = SHIPPED_SPLITS[name][1]
    results = {}
    for side, loader in (("jax", jax_load_split_dataset), ("port", load_split_dataset)):
        config = _shipped(name, tmp_path / side)
        ds = (JAX_REGISTRY if side == "jax" else DATASET_REGISTRY)[name](root_dir=str(tmp_path / side))
        writer(ds.raw_path)
        np.random.seed(11)
        results[side] = (ds, loader(config))
    (jax_ds, jax_split), (port_ds, port_split) = results["jax"], results["port"]
    split_dir = os.path.join(config["dataset"]["data_split"], "full_n_neg_100")
    files = sorted(os.listdir(os.path.join(jax_ds.processed_path, split_dir)))
    assert len(files) == 23 and files == sorted(os.listdir(os.path.join(port_ds.processed_path, split_dir)))
    string_items = name == "tafeng"
    for file in files:
        want, got = (os.path.join(ds.processed_path, split_dir, file) for ds in (jax_ds, port_ds))
        if string_items and file.startswith(("valid_", "test_")):
            same_npz(want, got, skip={"item_ids"})
            with np.load(want) as w, np.load(got) as g:
                assert w["item_ids"].dtype == np.int64 and g["item_ids"].dtype.kind == "U"
                np.testing.assert_array_equal(g["item_ids"], w["item_ids"].astype(str))
        else:
            same_npz(want, got)
    if string_items:
        assert all(len(frame) == 0 for frame in JaxBaseData(jax_split).valid)
        jax_split = jax_load_split_data(os.path.join(port_ds.processed_path, split_dir), n_test=10)
    want, got = JaxBaseData(jax_split), BaseData(port_split)
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
    for want_frame, got_frame in zip([want.train, *want.valid, *want.test], [got.train, *got.valid, *got.test]):
        want_cols = _columns(want_frame)
        assert sorted(got_frame) == sorted(want_cols) and len(want_frame) > 0
        for col, values in want_cols.items():
            np.testing.assert_array_equal(got_frame[col], values, err_msg=col)
    np.testing.assert_array_equal(got.pos_bitmask(), want.pos_bitmask())


def test_read_table_infers_as_pandas(tmp_path):
    import pandas as pd

    path = tmp_path / "t.tsv"
    write(str(path), "a\tb\tc\td\te\n1\t2.5\tx\t\t7\n-3\t\tNA\t4\t \n05\t1e3\ty z\tnan\t8\n")
    got = read_table(str(path), sep="\t", header=0)
    want = pd.read_table(str(path), sep="\t", header=0)
    for col in want.columns:
        w = want[col].to_numpy()
        assert got[col].dtype == (object if w.dtype.kind in "OUT" else w.dtype), col
        np.testing.assert_array_equal(got[col].astype(str), w.astype(str), err_msg=col)
    np.testing.assert_array_equal(epoch_seconds(["1970-01-02", "2014-04-07T10:51:09.999Z"]),
                                  [86400, seconds("2014-04-07 10:51:09", "%Y-%m-%d %H:%M:%S")])
