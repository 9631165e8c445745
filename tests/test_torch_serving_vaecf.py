"""The port serves the JAX package's trained seed-0 VAECF checkpoint (load ->
test -> predict -> recommend) with the JAX package's numbers on the CPU:
the user rows from the data, the test() metrics, the scores and the top-10
lists; and the checkpoint goes through the msgpack reader and writer both
ways."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.recommenders import VAECF as JaxVAECF
from beta_recsys_tpu_torch.config import load_config
from beta_recsys_tpu_torch.convert import params_to_jax
from beta_recsys_tpu_torch.core.checkpoint import load_metadata, load_raw_checkpoint, msgpack_serialize
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.recommenders import VAECF
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_PREDICTION_COL, DEFAULT_USER_COL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
CHECKPOINT = os.path.join(REPO, "parity_runs/checkpoints/VAECF_default_20260821_135516_yybcvt")
# The JAX package's VAECF(...).load(checkpoint, data).test() on this split.
EXPECTED = {"ndcg@10": 0.155424, "recall@10": 0.397667, "precision@10": 0.039767, "map@10": 0.084868}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(port recommender, JAX recommender, port test() row, JAX test() row)."""
    data = BaseData(load_split_data(SPLIT, n_test=1))
    cfg = load_config(CHECKPOINT).replace(system={"root_dir": str(tmp_path_factory.mktemp("port"))})
    ours = VAECF(cfg, device="cpu").load(CHECKPOINT, data)
    raw = load_metadata(CHECKPOINT)["config"]
    raw["system"]["root_dir"] = str(tmp_path_factory.mktemp("jax"))
    ref = JaxVAECF(JaxConfig(raw)).load(CHECKPOINT, JaxBaseData(jax_load_split_data(SPLIT, n_test=1)))
    return ours, ref, ours.test(), ref.test()


def test_the_user_rows_equal_jax(served):
    ours, ref, _, _ = served
    want = np.asarray(ref.model.artifacts["user_rows"])
    assert ours.model.artifacts["user_rows"].dtype == want.dtype == np.float32
    assert np.array_equal(ours.model.artifacts["user_rows"], want)
    assert set(np.unique(want)) == {0.0, 1.0}


def test_port_reproduces_checkpoint_metrics(served):
    _, _, got, want = served
    assert list(got) == sorted(want)
    for key, value in EXPECTED.items():
        assert abs(got[key] - value) < 1e-5, key
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)


def test_predict_and_recommend_match_jax(served):
    """predict() against the JAX model's candidate score of each pair (its
    VAECF has no pair score), recommend() against the JAX recommend()."""
    ours, ref, _, _ = served
    users, items = (ours.data.test[0][c][:300] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL))
    want = ref.model.score_candidates(ref._serving_params(True), jnp.asarray(users), jnp.asarray(items)[:, None])
    np.testing.assert_allclose(ours.predict({DEFAULT_USER_COL: users, DEFAULT_ITEM_COL: items}),
                               np.asarray(want)[:, 0], rtol=1e-6, atol=1e-9)
    got = ours.recommend(k=10)
    want = ref.recommend(k=10)
    for col in (DEFAULT_USER_COL, DEFAULT_ITEM_COL, "rank"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy(), err_msg=col)
    np.testing.assert_allclose(got[DEFAULT_PREDICTION_COL], want[DEFAULT_PREDICTION_COL].to_numpy(),
                               rtol=1e-6, atol=1e-9)
    train = ours.data.user_item_csr()
    assert not np.asarray(train[got[DEFAULT_USER_COL], got[DEFAULT_ITEM_COL]]).any()


def test_the_checkpoint_goes_through_msgpack_both_ways(served):
    ours, _, _, _ = served
    params = params_to_jax(ours.model.state_dict())
    restored = serialization.msgpack_restore(msgpack_serialize({"params": params}))["params"]
    want = load_raw_checkpoint(CHECKPOINT)["params"]
    assert set(restored) == set(want) == {"enc", "dec", "mu", "logvar"}
    for part in ("enc", "dec"):
        assert set(restored[part]) == set(want[part])
        for i in want[part]:
            for leaf in ("w", "b"):
                assert np.array_equal(restored[part][i][leaf], want[part][i][leaf]), (part, i, leaf)
    for part in ("mu", "logvar"):
        for leaf in ("w", "b"):
            assert np.array_equal(restored[part][leaf], want[part][leaf]), (part, leaf)
