"""Host-side helpers: the npz frame codec, seeding, CLI arguments, the
results CSV, timing, JSON, attribute access to a dict, unpacking a local
zip archive and the row normalization of a sparse matrix.

Counterpart of ``beta_recsys_tpu/utils/common.py`` without pandas: a frame is
a dict of equal-length numpy columns keyed by the column names of
``utils.constants``. ``save_dataframe_as_npz`` writes the JAX package's keys,
dtypes and ``storable`` rules and ``get_dataframe_from_npz`` reads them, so
each package reads the other's split cache. ``savez_compressed`` dates every
entry 1980-01-01, so equal frames give byte-identical files.
"""

import csv
import io
import json
import os
import random
import time
import zipfile
from functools import wraps

import numpy as np

from .constants import (
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


def ensure_dir(path):
    """Create the directory ``path`` if it is missing."""
    if path and not os.path.exists(path):
        os.makedirs(path, exist_ok=True)


def set_seed(seed):
    """Seed Python's and numpy's global generators."""
    random.seed(seed)
    np.random.seed(seed)


def _storable(arr, prefer_int=False):
    """String columns (object or unicode: string ids) as fixed-width
    unicode, or int64 where ``prefer_int`` and they parse, so ``np.load``
    needs no pickle."""
    arr = np.asarray(arr)
    if arr.dtype == object or arr.dtype.kind == "U":
        if prefer_int:
            try:
                return arr.astype(np.int64)
            except (ValueError, TypeError, OverflowError):
                pass
        return arr.astype(str)
    return arr.astype(np.int64) if prefer_int else arr


def save_dataframe_as_npz(frame, data_file):
    """Write a frame to a compressed npz: user_ids, item_ids, ratings
    (float32), order_ids where the frame has orders, and timestamps (int64,
    or float32 zeros where the frame has none)."""
    data = {
        "user_ids": _storable(frame[DEFAULT_USER_COL]),
        "item_ids": _storable(frame[DEFAULT_ITEM_COL]),
        "ratings": np.asarray(frame[DEFAULT_RATING_COL]).astype(np.float32),
    }
    if DEFAULT_ORDER_COL in frame:
        data["order_ids"] = _storable(frame[DEFAULT_ORDER_COL], prefer_int=True)
    if DEFAULT_TIMESTAMP_COL in frame:
        data["timestamps"] = _storable(frame[DEFAULT_TIMESTAMP_COL], prefer_int=True)
    else:
        data["timestamps"] = np.zeros_like(data["ratings"])
    ensure_dir(os.path.dirname(data_file))
    savez_compressed(data_file, **data)


def savez_compressed(path, **arrays):
    """``np.savez_compressed(path, **arrays)`` with every entry dated
    1980-01-01 in place of the time of writing (equal arrays, equal bytes)
    and deflated at level 1: a split's negative-sampled copies of string ids
    compress 5x faster than at numpy's level 6, into files ~30% larger."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_DEFLATED, allowZip64=True) as zf:
        for key, value in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asanyarray(value), allow_pickle=False)
            zf.writestr(zipfile.ZipInfo(f"{key}.npy", date_time=(1980, 1, 1, 0, 0, 0)), buf.getvalue(),
                        compress_type=zipfile.ZIP_DEFLATED, compresslevel=1)


def inner_join_rows(left_keys, right_keys):
    """(left rows, right rows) of pandas' inner merge on key columns (lists
    of equal-length arrays, one a key): every left row in order, beside each
    right row with its key in the right frame's order."""
    n_left = len(left_keys[0])
    codes = np.zeros(n_left + len(right_keys[0]), dtype=np.int64)
    for lk, rk in zip(left_keys, right_keys):
        uniq, inverse = np.unique(np.concatenate([lk, rk]), return_inverse=True)
        codes = codes * len(uniq) + inverse.reshape(-1)
    left, right = codes[:n_left], codes[n_left:]
    order = np.argsort(right, kind="stable")
    lo = np.searchsorted(right[order], left, "left")
    counts = np.searchsorted(right[order], left, "right") - lo
    starts = np.repeat(lo - (np.cumsum(counts) - counts), counts)
    return np.repeat(np.arange(n_left), counts), order[starts + np.arange(counts.sum())]


def get_dataframe_from_npz(data_file):
    """One npz file -> {column name: numpy array}, the inverse of
    ``save_dataframe_as_npz`` (the JAX package's files too)."""
    with np.load(data_file, allow_pickle=False) as z:
        frame = {col: z[key] for key, col in _NPZ_COLUMNS.items() if key in z}
    for col in (DEFAULT_USER_COL, DEFAULT_ITEM_COL, DEFAULT_RATING_COL):
        if col not in frame:
            raise ValueError(f"{data_file} has no {col} column")
    return frame


def update_args(config, args):
    """Override a raw config dict's entries from a flat dict of arguments: a
    key that is not None replaces the matching key in every section that has
    it."""
    for key, value in args.items():
        if value is None:
            continue
        for section in config:
            if isinstance(config[section], dict) and key in config[section]:
                config[section][key] = value


def print_dict_as_table(dic, tag=None, columns=("keys", "values")):
    """Print a dict as a two-column table; returns the text."""
    rows = [f"{k!s:>24} | {v!s}" for k, v in sorted(dic.items(), key=lambda x: str(x[0]))]
    out = "\n".join(([tag] if tag else []) + [f"{columns[0]:>24} | {columns[1]}", "-" * 48] + rows)
    print(out)
    return out


def _csv_value(value):
    """A value as pandas' ``to_csv`` writes it: shortest round-trip reprs,
    None and NaN empty."""
    if value is None or (isinstance(value, float) and value != value):
        return ""
    if isinstance(value, np.generic):
        value = value.item()
    return str(value) if isinstance(value, float) else value


def save_to_csv(rows, result_file):
    """Append ``rows`` (a list of dicts, or one dict) to a CSV, creating it
    with a header if absent. A column the file lacks is added at the end,
    and earlier rows leave it empty, as pandas' concat of the file and the
    rows writes them."""
    rows = [rows] if isinstance(rows, dict) else list(rows)
    ensure_dir(os.path.dirname(result_file))
    prior, fields = [], []
    if os.path.exists(result_file):
        with open(result_file, newline="") as f:
            reader = csv.DictReader(f)
            fields = list(reader.fieldnames or [])
            prior = list(reader)
    for row in rows:
        fields += [k for k in row if k not in fields]
    with open(result_file, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(prior)
        writer.writerows({k: _csv_value(v) for k, v in row.items()} for row in rows)


def timeit(method):
    """Decorator printing the wall-clock time of each call (ms)."""

    @wraps(method)
    def wrapper(*args, **kw):
        t0 = time.time()
        result = method(*args, **kw)
        print(f"Execute [{method.__name__}] method costing {(time.time() - t0) * 1000:2.2f} ms")
        return result

    return wrapper


def str2bool(v):
    """Parse a human bool string."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"Boolean value expected, got {v!r}.")


class DictToObject:
    """Wrap a dict so keys are attribute-accessible (recursively)."""

    def __init__(self, dictionary):
        for key, val in dictionary.items():
            if isinstance(val, dict):
                val = DictToObject(val)
            setattr(self, key, val)


def un_zip(file_name, target_dir=None):
    """Unzip a local zip archive into target_dir (defaults to its directory)."""
    if target_dir is None:
        target_dir = os.path.dirname(file_name)
    with zipfile.ZipFile(file_name) as zf:
        zf.extractall(target_dir)


def normalized_adj_single(adj):
    """Row-normalize a scipy sparse matrix: D^-1 A as COO (rows of degree 0
    stay 0)."""
    import scipy.sparse as sp

    rowsum = np.array(adj.sum(1)).flatten()
    d_inv = np.where(rowsum > 0, 1.0 / np.maximum(rowsum, 1e-12), 0.0)
    return sp.diags(d_inv).dot(adj).tocoo()


def write_json(obj, path):
    ensure_dir(os.path.dirname(path))
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)
