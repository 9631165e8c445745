"""The slice as a whole: the port serves the JAX package's trained SASRec
checkpoint (load -> test -> predict -> recommend) with the JAX package's
numbers, on the CPU."""

import csv
import os

import numpy as np
import pytest

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.data.sequential_data import SequentialData as JaxSequentialData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.recommenders import SASRec as JaxSASRec
from beta_recsys_tpu_torch.config import load_config
from beta_recsys_tpu_torch.core.checkpoint import load_metadata
from beta_recsys_tpu_torch.data.sequential_data import SequentialData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.recommenders import SASRec
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_PREDICTION_COL, DEFAULT_USER_COL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "parity_runs/checkpoints/SASRec_default_20260821_081415_yybcvt")
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
# The JAX package's SASRec(...).load(CHECKPOINT, data).test() on this split.
EXPECTED = {"ndcg@10": 0.186726, "recall@10": 0.458112, "precision@10": 0.045811, "map@10": 0.106825}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(port recommender, JAX recommender, port test() row, JAX test() row,
    port result dir, JAX result dir)."""
    roots = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
    cfg = load_config(CHECKPOINT).replace(system={"root_dir": str(roots[0])})
    ours = SASRec(cfg, device="cpu").load(CHECKPOINT, SequentialData(load_split_data(SPLIT, n_test=1)))
    raw = load_metadata(CHECKPOINT)["config"]
    raw["system"]["root_dir"] = str(roots[1])
    ref = JaxSASRec(JaxConfig(raw)).load(CHECKPOINT, JaxSequentialData(jax_load_split_data(SPLIT, n_test=1)))
    return ours, ref, ours.test(), ref.test(), roots


def test_port_reproduces_checkpoint_metrics(served):
    _, _, ours, _, _ = served
    for key, want in EXPECTED.items():
        assert abs(ours[key] - want) < 1e-5, key


def test_every_metric_equals_jax_test(served):
    _, _, ours, ref, _ = served
    assert list(ours) == list(ref)
    for key in ref:
        # float32 means over 943 users, reduced in another order
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-6, atol=1e-7, err_msg=key)


def test_result_csv_has_the_jax_columns(served):
    _, _, _, _, roots = served
    headers = []
    for root in roots:
        with open(os.path.join(root, "results", "parity_SASRec.csv"), newline="") as f:
            headers.append(next(csv.reader(f)))
    assert headers[0] == headers[1]


def test_recommend_matches_jax(served):
    ours, ref, _, _, _ = served
    users = np.arange(50)
    got = ours.recommend(users=users, k=10)
    want = ref.recommend(users=users, k=10)
    for col in (DEFAULT_USER_COL, DEFAULT_ITEM_COL, "rank"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy(), err_msg=col)
    np.testing.assert_allclose(got[DEFAULT_PREDICTION_COL], want[DEFAULT_PREDICTION_COL].to_numpy(), rtol=1e-5, atol=1e-5)
    train = ours.data.user_item_csr()
    assert not np.asarray(train[got[DEFAULT_USER_COL], got[DEFAULT_ITEM_COL]]).any()


def test_recommend_without_exclusion_matches_jax(served):
    ours, ref, _, _, _ = served
    got = ours.recommend(users=[3, 1, 4], k=5, exclude_train=False)
    want = ref.recommend(users=[3, 1, 4], k=5, exclude_train=False)
    np.testing.assert_array_equal(got[DEFAULT_ITEM_COL], want[DEFAULT_ITEM_COL].to_numpy())
    np.testing.assert_array_equal(got[DEFAULT_USER_COL], [3] * 5 + [1] * 5 + [4] * 5)


def test_predict_matches_jax(served):
    ours, ref, _, _, _ = served
    frame = {c: ours.data.test[0][c][:200] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    got = ours.predict(frame)
    want = ref.predict(ref.data.test[0].iloc[:200])
    assert got.shape == (200,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_load_rejects_data_of_another_shape(tmp_path):
    split = load_split_data(SPLIT, n_test=1)
    small = {c: v[split[0]["col_user"] < 900] for c, v in split[0].items()}
    with pytest.raises(ValueError, match="943"):
        SASRec(load_config(CHECKPOINT), device="cpu").load(CHECKPOINT, SequentialData((small, *split[1:])))


def test_out_of_range_ids_raise_on_the_host(served):
    ours = served[0]
    with pytest.raises(ValueError, match="user ids"):
        ours.recommend(users=[0, 943], k=5)
    with pytest.raises(ValueError, match="item ids"):
        ours.predict({DEFAULT_USER_COL: np.array([0]), DEFAULT_ITEM_COL: np.array([-1])})
