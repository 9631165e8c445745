"""The port's msgpack reader decodes flax checkpoints exactly as flax does."""

import glob
import os

import numpy as np
import pytest
from flax import serialization

from beta_recsys_tpu_torch.core.checkpoint import load_raw_checkpoint, msgpack_restore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SASREC_CHECKPOINTS = sorted(glob.glob(os.path.join(REPO, "parity_runs/checkpoints/SASRec_*/checkpoint.msgpack")))


def assert_same_tree(a, b, path="root"):
    assert type(a) is type(b), f"{path}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for key in a:
            assert_same_tree(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, np.generic):
        assert a.dtype == b.dtype and a == b, path
    else:
        assert a == b, path


def test_sasrec_checkpoints_exist():
    assert len(SASREC_CHECKPOINTS) >= 1


@pytest.mark.parametrize("path", SASREC_CHECKPOINTS, ids=lambda p: os.path.basename(os.path.dirname(p)))
def test_reader_equals_flax_on_sasrec_checkpoint(path):
    with open(path, "rb") as f:
        data = f.read()
    ours = msgpack_restore(data)
    assert_same_tree(ours, serialization.msgpack_restore(data))
    assert set(ours["params"]["blocks"]) == {"0", "1"}  # lists arrive as "0", "1" maps
    assert_same_tree(load_raw_checkpoint(os.path.dirname(path)), ours)


def test_reader_equals_flax_on_made_up_tree():
    tree = {
        "count": np.int32(7),
        "flags": [True, False, None],
        "nested": [[1, -3, 2**40, -(2**40)], {"deep": [np.float32(1.5), 2.25, "text"]}],
        "blocks": [{"w": np.arange(6, dtype=np.int32).reshape(2, 3)}, {"w": np.ones((1,), np.float64)}],
        "empty": np.zeros((0, 4), np.float32),
        "raw": b"\x00\x01bytes",
        "big": np.arange(70_000, dtype=np.int64),
        "small_ints": [0, 127, 128, 255, 256, 65536, -1, -32, -33, -129, -32769],
        "long_str": "x" * 300,
        "many_keys": {str(i): i for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


def test_reader_rejects_truncated_data():
    data = serialization.msgpack_serialize({"a": np.arange(10, dtype=np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-3])
