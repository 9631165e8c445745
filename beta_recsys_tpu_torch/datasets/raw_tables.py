"""Delimited raw files as frames of numpy columns (numpy and the standard
library only).

The dataset adapters of ``beta_recsys_tpu/datasets/`` read their raw files
with ``pd.read_table`` / ``pd.read_csv``. ``read_table`` is the part of that
reader they use, with pandas' column inference, so that the port's
interaction npz files equal the JAX package's array for array:

- a column whose every field is an integer is int64; else one whose every
  field is a number or a missing value is float64 (missing: NaN); else it
  holds the field strings, with NaN where a field is missing (pandas' default
  ``na_values``), as an object array;
- ``header=None`` numbers the columns 0.., ``header=0`` takes their names
  from the first line; ``names`` renames them; ``usecols`` picks columns by
  position or by name, in file order; blank lines are skipped; a one-byte
  separator follows the ``csv`` module's quoting, as pandas' C parser does,
  and a longer one (``"::"``) splits each line, as pandas' python engine does.

``epoch_seconds`` parses date strings into true epoch seconds, where the JAX
adapters' ``pd.to_datetime(col).astype(np.int64) // 10**9`` stores seconds
// 1000 under pandas 3 (ROADMAP.md, notes on the reference).
"""

import csv
import re

import numpy as np

# pandas' default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES).
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A",
    "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_FLOAT = re.compile(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|Inf|INF|infinity|Infinity)\s*")


def _all_ints(fields):
    """int64 of the fields where every one is an integer (a signed digit
    string, spaces around it allowed), else None."""
    arr = np.array(fields, dtype=str)
    if len(arr) and np.char.isdigit(np.char.lstrip(np.char.strip(arr), "+-")).all():
        try:
            return arr.astype(np.int64)
        except (ValueError, OverflowError):
            return None
    return None


def infer_column(fields):
    """One column's field strings as pandas' parser types them."""
    ints = _all_ints(fields)
    if ints is not None:
        return ints
    missing = [f in NA_VALUES for f in fields]
    if all(m or _FLOAT.fullmatch(f) for f, m in zip(fields, missing)):
        return np.array([np.nan if m else float(f) for f, m in zip(fields, missing)], dtype=np.float64)
    return np.array([np.nan if m else f for f, m in zip(fields, missing)], dtype=object)


def _rows(path, sep, encoding):
    """The file's non-blank lines as lists of fields."""
    if encoding.replace("-", "").lower() == "utf8":
        encoding = "utf-8-sig"  # pandas skips a leading byte-order mark
    with open(path, newline="" if len(sep) == 1 else None, encoding=encoding) as f:
        if len(sep) == 1:
            return [row for row in csv.reader(f, delimiter=sep) if row]
        return [line.split(sep) for line in f.read().split("\n") if line]


def read_table(path, sep="\t", header=None, names=None, usecols=None, encoding="utf-8"):
    """``pd.read_table(path, sep=sep, header=header, names=names,
    usecols=usecols, encoding=encoding)`` as {column name: numpy array}.

    A row shorter than the header is padded with missing fields."""
    rows = _rows(path, sep, encoding)
    if header == 0:
        columns, rows = rows[0] if rows else [], rows[1:]
    elif header is None:
        columns = list(range(len(rows[0]))) if rows else []
    else:
        raise ValueError(f"header={header!r}: only None and 0 are read")
    if usecols is not None:
        positions = sorted(columns.index(c) if isinstance(c, str) else c for c in usecols)
    else:
        positions = list(range(len(names) if names is not None and header is None else len(columns)))
    if names is None:
        names = [columns[p] for p in positions]
    if len(names) != len(positions):
        raise ValueError(f"{path}: {len(names)} names for {len(positions)} columns")
    return {name: infer_column([row[p] if p < len(row) else "" for row in rows]) for name, p in zip(names, positions)}


def epoch_seconds(values):
    """Date strings ("2010-10-19T23:55:27Z", "2014-12-06 02",
    "2014-04-07T10:51:09.277Z", "2016-05-09") as int64 seconds since
    1970-01-01 UTC, a fraction of a second dropped."""
    stamps = np.array([str(v).strip().removesuffix("Z") for v in values], dtype="datetime64[s]")
    return stamps.astype(np.int64)
