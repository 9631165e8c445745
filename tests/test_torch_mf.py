"""MF in the port against the JAX package, on the same parameters (carried
across by convert.py) and the same numpy inputs: scores, losses and their
gradients, the factorized retrieval form; plus the losses module."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beta_recsys_tpu.config import Config as JaxConfig
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.models import losses as jax_losses
from beta_recsys_tpu.models.mf import MF as JaxMF
from beta_recsys_tpu.recommenders import MatrixFactorization as JaxMatrixFactorization
from beta_recsys_tpu_torch.config import load_config
from beta_recsys_tpu_torch.convert import mf_params_from_jax, params_to_jax
from beta_recsys_tpu_torch.core.checkpoint import load_metadata
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.datasets.data_split import load_split_data
from beta_recsys_tpu_torch.models import build_model, losses
from beta_recsys_tpu_torch.models.mf import MF
from beta_recsys_tpu_torch.recommenders import MatrixFactorization
from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL, DEFAULT_PREDICTION_COL, DEFAULT_USER_COL

TOL = 1e-5  # float32, reduced in other orders
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "parity_runs/checkpoints/MF_default_20260821_134231_aaquvl")
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
# The JAX package's MatrixFactorization(...).load(CHECKPOINT, data).test() on this split.
EXPECTED = {"ndcg@10": 0.189677, "recall@10": 0.411453, "precision@10": 0.041145, "map@10": 0.123563}
N_USERS, N_ITEMS, D, B = 23, 31, 12, 9


def _pair(reg=0.01, loss="bpr", seed=0):
    """The JAX model and the port's on the same random params (non-zero
    biases, so every term is held)."""
    cfg = {"model": "MF", "emb_dim": D, "reg": reg, "loss": loss}
    ref = JaxMF(cfg, N_USERS, N_ITEMS)
    params = jax.tree_util.tree_map(np.asarray, ref.init_params(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params["user_bias"] = rng.standard_normal(N_USERS).astype(np.float32)
    params["item_bias"] = rng.standard_normal(N_ITEMS).astype(np.float32)
    params["global_bias"] = np.float32(0.3)
    ours = MF(cfg, N_USERS, N_ITEMS, device="cpu")
    ours.load_state_dict(mf_params_from_jax(params))
    return ref, ours, params


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return {
        "users": rng.integers(0, N_USERS, B).astype(np.int32),
        "pos_items": rng.integers(0, N_ITEMS, B).astype(np.int32),
        "neg_items": rng.integers(0, N_ITEMS, B).astype(np.int32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_scores_match_jax():
    ref, ours, params = _pair()
    b = _batch()
    users, items = b["users"], b["pos_items"]
    cands = np.random.default_rng(2).integers(0, N_ITEMS, (B, 7)).astype(np.int32)
    with torch.no_grad():
        _close(ours.score_pairs(torch.from_numpy(users).long(), torch.from_numpy(items).long()),
               ref.score_pairs(params, jnp.asarray(users), jnp.asarray(items)))
        _close(ours.score_candidates(torch.from_numpy(users).long(), torch.from_numpy(cands).long()),
               ref.score_candidates(params, jnp.asarray(users), jnp.asarray(cands)))
        _close(ours.score_all(torch.from_numpy(users).long()), ref.score_all(params, jnp.asarray(users)))


def test_factorized_form_matches_jax():
    ref, ours, params = _pair()
    with torch.no_grad():
        u_ext, i_ext = ours.user_item_embeddings()
        want_u, want_i = ref.user_item_embeddings(params)
        _close(u_ext, want_u)
        _close(i_ext, want_i)
        raw = u_ext @ i_ext.T
        _close(ours.retrieval_score_transform(raw), ref.retrieval_score_transform(params, jnp.asarray(raw.numpy())))
        _close(ours.retrieval_score_transform(raw), ours.score_all(torch.arange(N_USERS)))


@pytest.mark.parametrize("reg", [0.0, 0.05])
def test_bpr_loss_and_gradients_match_jax(reg):
    ref, ours, params = _pair(reg=reg)
    b = _batch()
    want_loss, want_grads = jax.value_and_grad(ref.loss)(
        jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in b.items()}, None
    )
    loss = ours.loss(_torch_batch(b))
    loss.backward()
    _close(loss, want_loss)
    for name, p in ours.named_parameters():
        _close(p.grad, want_grads[name])


def test_bce_loss_matches_jax():
    ref, ours, params = _pair(loss="bce")
    rng = np.random.default_rng(3)
    b = {"users": rng.integers(0, N_USERS, B).astype(np.int32),
         "items": rng.integers(0, N_ITEMS, B).astype(np.int32),
         "labels": rng.integers(0, 2, B).astype(np.float32)}
    want = ref.loss(params, {k: jnp.asarray(v) for k, v in b.items()}, None)
    got = ours.loss({"users": torch.from_numpy(b["users"]).long(), "items": torch.from_numpy(b["items"]).long(),
                     "labels": torch.from_numpy(b["labels"])})
    _close(got, want)
    assert ours.batch_kind == "pointwise"


@pytest.mark.parametrize("reg", [0.0, 0.05])
def test_row_loss_and_row_gradients_match_jax(reg):
    ref, ours, params = _pair(reg=reg)
    b = _batch()
    role_ids = {"users": b["users"], "items_cat": np.concatenate([b["pos_items"], b["neg_items"]])}
    np_rows = {name: params[name][role_ids[role]] for name, role in ref.row_tables().items()}
    dense = {"global_bias": jnp.asarray(params["global_bias"])}
    want_loss, (want_rows, want_dense) = jax.value_and_grad(ref.row_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in np_rows.items()}, dense, {k: jnp.asarray(v) for k, v in b.items()}, None
    )
    rows = {k: torch.from_numpy(v).requires_grad_() for k, v in np_rows.items()}
    g = torch.tensor(params["global_bias"], requires_grad=True)
    loss = ours.row_loss(rows, {"global_bias": g}, _torch_batch(b))
    grads = torch.autograd.grad(loss, [*rows.values(), g])
    assert ours.row_tables() == ref.row_tables()
    _close(loss, want_loss)
    for name, grad in zip(rows, grads):
        _close(grad, want_rows[name])
    _close(grads[-1], want_dense["global_bias"])


def test_row_loss_counts_users_once_and_loss_twice():
    """The two L2 terms differ on purpose, as in the JAX package."""
    _, ours, params = _pair(reg=1.0)
    zero = dict(params, global_bias=np.float32(0.0))
    ours.load_state_dict(mf_params_from_jax(zero))
    b = _torch_batch(_batch())
    with torch.no_grad():
        u, pos, neg = b["users"], b["pos_items"], b["neg_items"]
        items = torch.cat([pos, neg])
        rows = {"user_emb": ours.user_emb[u], "item_emb": ours.item_emb[items],
                "user_bias": ours.user_bias[u], "item_bias": ours.item_bias[items]}
        base = losses.bpr_loss(ours.score_pairs(u, pos), ours.score_pairs(u, neg))
        user_sq = ((ours.user_emb[u] ** 2).sum() + (ours.user_bias[u] ** 2).sum()) / B
        row = ours.row_loss(rows, {"global_bias": ours.global_bias}, b)
        dense = ours.loss(b)
    torch.testing.assert_close(dense - row, user_sq, rtol=1e-5, atol=1e-5)
    assert row > base


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal(50).astype(np.float32), rng.standard_normal(50).astype(np.float32)
    p = 1 / (1 + np.exp(-a))
    labels = (rng.random(50) < 0.5).astype(np.float32)
    _close(losses.bpr_loss(torch.from_numpy(a), torch.from_numpy(b)), jax_losses.bpr_loss(a, b))
    _close(losses.bce_loss(torch.from_numpy(p), torch.from_numpy(labels)), jax_losses.bce_loss(p, labels))
    _close(losses.l2_reg(torch.from_numpy(a), torch.from_numpy(b), batch_size=7), jax_losses.l2_reg(a, b, batch_size=7))


def test_init_and_conversion_round_trip():
    ours = build_model({"model": "MF", "emb_dim": D, "stddev": 0.1}, N_USERS, N_ITEMS, device="cpu")
    ours.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert abs(float(ours.user_emb.std()) - 0.1) < 0.02 and float(ours.item_emb.abs().mean()) > 0
        assert not ours.user_bias.any() and not ours.item_bias.any() and float(ours.global_bias) == 0.0
    tree = params_to_jax(ours.state_dict())
    ref = JaxMF({"emb_dim": D}, N_USERS, N_ITEMS).init_params(jax.random.key(0))
    assert {k: np.shape(v) for k, v in tree.items()} == {k: v.shape for k, v in ref.items()}
    back = MF({"emb_dim": D}, N_USERS, N_ITEMS, device="cpu")
    back.load_state_dict(mf_params_from_jax(tree))
    for (name, p), q in zip(ours.named_parameters(), back.parameters()):
        assert torch.equal(p, q), name


def test_port_serves_the_jax_mf_checkpoint(tmp_path):
    """load -> test -> predict -> recommend on the JAX-trained checkpoint give
    the JAX package's numbers."""
    cfg = load_config(CHECKPOINT).replace(system={"root_dir": str(tmp_path / "port")})
    ours = MatrixFactorization(cfg, device="cpu").load(CHECKPOINT, BaseData(load_split_data(SPLIT, n_test=1)))
    raw = load_metadata(CHECKPOINT)["config"]
    raw["system"]["root_dir"] = str(tmp_path / "jax")
    ref = JaxMatrixFactorization(JaxConfig(raw)).load(CHECKPOINT, JaxBaseData(jax_load_split_data(SPLIT, n_test=1)))
    got, want = ours.test(), ref.test()
    for key, value in EXPECTED.items():
        assert abs(got[key] - value) < 1e-5, key
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)
    frame = {c: ours.data.test[0][c][:100] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    np.testing.assert_allclose(ours.predict(frame), np.asarray(ref.predict(ref.data.test[0].iloc[:100])), rtol=1e-5, atol=1e-6)
    users = np.arange(40)
    got_rec, want_rec = ours.recommend(users=users, k=10), ref.recommend(users=users, k=10)
    np.testing.assert_array_equal(got_rec[DEFAULT_ITEM_COL], want_rec[DEFAULT_ITEM_COL].to_numpy())
    np.testing.assert_allclose(got_rec[DEFAULT_PREDICTION_COL], want_rec[DEFAULT_PREDICTION_COL].to_numpy(), rtol=1e-5, atol=1e-6)
