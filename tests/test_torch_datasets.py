"""The port's dataset layer against the JAX package's: the port regenerates
the committed ``datasets/synthetic_structured`` interaction npz and its
``leave_one_out`` train/valid/test equal to the committed files;
``load_split_dataset`` with every split alias returns the JAX package's
frames; an adapter without its raw file raises; the sequence helpers equal JAX's."""

import os

import numpy as np
import pandas as pd
import pytest
from test_torch_data_split import same_frame

from beta_recsys_tpu.datasets import load_split_dataset as jax_load_split_dataset
from beta_recsys_tpu.datasets import seq_data_utils as jax_seq
from beta_recsys_tpu_torch.datasets import DATASET_REGISTRY, build_dataset, load_split_dataset, seq_data_utils
from beta_recsys_tpu_torch.datasets.data_load import load_item_fea_dic, load_user_fea_dic, load_user_item_feature
from beta_recsys_tpu_torch.datasets.synthetic import SyntheticStructured

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "datasets", "synthetic_structured", "processed")
SPLIT_ALIASES = ["random", "random_basket", "temporal", "temporal_basket", "random_split", "random_basket_split",
                 "temporal_split", "temporal_basket_split", "leave_one_out", "leave_one_basket"]


def test_port_regenerates_the_committed_structured_split(tmp_path):
    """The interactions and the leave_one_out split, array for array and in
    row order (valid_i/test_i depend on numpy's global state when they were
    made, so only the negative-free files are held)."""
    dataset = SyntheticStructured(root_dir=str(tmp_path))
    dataset.make_leave_one_out(n_negative=100, n_test=1)
    for rel in ["synthetic_structured_interaction.npz", "leave_one_out/full_n_neg_100/train.npz",
                "leave_one_out/full_n_neg_100/valid.npz", "leave_one_out/full_n_neg_100/test.npz"]:
        with np.load(os.path.join(COMMITTED, rel)) as want, np.load(os.path.join(dataset.processed_path, rel)) as got:
            assert list(want.keys()) == list(got.keys()), rel
            for key in want:
                assert want[key].dtype == got[key].dtype and want[key].shape == got[key].shape, (rel, key)
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{rel} {key}")


def _config(root, split, dataset="synthetic", **extra):
    return {"dataset": {"dataset": dataset, "root_dir": str(root), "data_split": split, "n_test": 2,
                        "n_negative": 5, "test_rate": 0.2, **extra}}


@pytest.mark.parametrize("split", SPLIT_ALIASES)
def test_load_split_dataset_matches_jax_for_every_alias(tmp_path, split):
    np.random.seed(4)
    want = jax_load_split_dataset(_config(tmp_path / "jax", split))
    np.random.seed(4)
    got = load_split_dataset(_config(tmp_path / "port", split))
    same_frame(want[0], got[0], "train")
    assert len(got[1]) == len(got[2]) == 2
    for want_copy, got_copy in zip(want[1] + want[2], got[1] + got[2]):
        same_frame(want_copy, got_copy, split)
    # A second load reads the cache: no draw, the same frames.
    again = load_split_dataset(_config(tmp_path / "port", split))
    for got_copy, again_copy in zip(got[1], again[1]):
        for col in got_copy:
            np.testing.assert_array_equal(again_copy[col], got_copy[col])


def test_every_negative_loads_one_copy_and_a_kcore_applies(tmp_path):
    np.random.seed(2)
    want = jax_load_split_dataset(_config(tmp_path / "jax", "leave_one_out", n_negative=-1, n_test=3, min_i_c=60))
    np.random.seed(2)
    got = load_split_dataset(_config(tmp_path / "port", "leave_one_out", n_negative=-1, n_test=3, min_i_c=60))
    assert len(got[1]) == len(got[2]) == 1
    same_frame(want[0], got[0])
    for want_copy, got_copy in zip(want[1] + want[2], got[1] + got[2]):
        same_frame(want_copy, got_copy)


def test_unknown_split_and_dataset_raise(tmp_path):
    with pytest.raises(KeyError, match="Unknown data_split"):
        load_split_dataset(_config(tmp_path, "by_magic"))
    with pytest.raises(KeyError, match="Unknown dataset"):
        build_dataset(_config(tmp_path, "leave_one_out", dataset="nope"))


@pytest.mark.parametrize("name", ["ml_100k", "amazon_books", "tafeng", "instacart_25"])
def test_a_download_adapter_raises(tmp_path, name):
    """Without its raw file an adapter raises, naming the file and the raw
    directory: the port downloads nothing."""
    assert name in DATASET_REGISTRY
    with pytest.raises(RuntimeError, match="downloads nothing") as err:
        load_split_dataset(_config(tmp_path, "leave_one_out", dataset=name))
    assert os.path.join(str(tmp_path), "datasets", name, "raw") in str(err.value)


def test_downloads_raise(tmp_path):
    dataset = SyntheticStructured(root_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="downloads no processed split"):
        dataset.download_processed_split("leave_one_out", str(tmp_path))
    with pytest.raises(RuntimeError, match="downloads no processed split"):
        load_split_dataset(_config(tmp_path, "leave_one_out", dataset="synthetic_structured", download=True))


def test_feature_readers(tmp_path):
    raw = tmp_path / "datasets" / "toy" / "raw"
    for side in ("item", "user"):
        (raw / f"{side}_fea").mkdir(parents=True)
        (raw / f"{side}_fea" / "one_hot.csv").write_text("3 1 0 0.5\n\n7 0 1 2\n")
    processed = tmp_path / "datasets" / "toy" / "processed"
    processed.mkdir(parents=True)
    np.savez(processed / "toy_fea_vec.npz", user_feat=np.eye(2), item_feat=np.ones((3, 2)))
    cfg = {"dataset": {"dataset": "toy", "root_dir": str(tmp_path)}}
    for reader in (load_item_fea_dic, load_user_fea_dic):
        got = reader(cfg, "one_hot")
        assert list(got) == [3, 7] and got[3].dtype == np.float32
        np.testing.assert_array_equal(got[7], [0, 1, 2])
    user_feat, item_feat = load_user_item_feature(cfg)
    assert user_feat.shape == (2, 2) and item_feat.shape == (3, 2)


def test_sequence_helpers_match_jax():
    rng = np.random.default_rng(0)
    n = 200
    frame = {"col_user": rng.integers(0, 12, n), "col_item": rng.integers(0, 40, n) * 3,
             "col_timestamp": rng.integers(0, 30, n), "col_rating": np.ones(n, np.float32)}
    valid = {k: v[:50] for k, v in frame.items()}
    want = jax_seq.reindex_items(pd.DataFrame(frame), pd.DataFrame(valid))
    got = seq_data_utils.reindex_items(frame, valid)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g["col_item"], w["col_item"].to_numpy())
        np.testing.assert_array_equal(g["col_user"], w["col_user"].to_numpy())
    want_db, got_db = jax_seq.create_seq_db(pd.DataFrame(frame)), seq_data_utils.create_seq_db(frame)
    np.testing.assert_array_equal(got_db["col_user"], want_db["col_user"].to_numpy())
    assert got_db["item_list"] == [list(x) for x in want_db["item_list"]]
    assert seq_data_utils.dataset_to_seq_target_format(got_db) == jax_seq.dataset_to_seq_target_format(want_db)
    seqs, targets = seq_data_utils.dataset_to_seq_target_format(got_db)
    for pad_left in (True, False):
        np.testing.assert_array_equal(seq_data_utils.pad_sequences(seqs, 5, pad_left),
                                      jax_seq.pad_sequences(seqs, 5, pad_left))
    batch = list(zip(seqs[:9], targets[:9]))
    for g, w in zip(seq_data_utils.collate_fn(batch), jax_seq.collate_fn(batch)):
        np.testing.assert_array_equal(g, w)
    dataset = seq_data_utils.SeqDataset(seqs, targets, 6)
    rows = sum(len(t) for _, t, _ in dataset.batches(16, rng=np.random.default_rng(1)))
    assert rows == len(dataset) == len(targets)
