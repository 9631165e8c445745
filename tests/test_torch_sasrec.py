"""SASRec in the port against the JAX package, on the same parameters
(carried across by convert.py) and the same numpy inputs; plus layer_norm
and the ranking metrics."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beta_recsys_tpu.core.checkpoint import load_raw_checkpoint as jax_load_raw_checkpoint
from beta_recsys_tpu.data.sequential_data import SequentialData as JaxSequentialData
from beta_recsys_tpu.datasets.data_split import load_split_data as jax_load_split_data
from beta_recsys_tpu.models.sasrec import SASRec as JaxSASRec
from beta_recsys_tpu.ops import metrics as jax_metrics
from beta_recsys_tpu.ops.attention import layer_norm as jax_layer_norm
from beta_recsys_tpu_torch.convert import sasrec_params_from_jax
from beta_recsys_tpu_torch.models.sasrec import SASRec
from beta_recsys_tpu_torch.ops import metrics
from beta_recsys_tpu_torch.ops.attention import layer_norm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "parity_runs/checkpoints/SASRec_default_20260821_081415_yybcvt")
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
TOL = 1e-5  # float32 forward through 2 blocks, summed in other orders


def _pair(cfg, n_users, n_items, ctx, params):
    """The JAX model and the port's, on the same params and context."""
    ref = JaxSASRec(cfg, n_users, n_items, artifacts={"ctx": ctx})
    ours = SASRec(cfg, n_users, n_items, artifacts={"ctx": ctx}, device="cpu")
    ours.load_state_dict(sasrec_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return ref, ours


def _check_scores(ref, ours, params, users, cands):
    with torch.no_grad():
        feats = ours.log2feats(ours.ctx[torch.from_numpy(users)])
        got_all = ours.score_all(torch.from_numpy(users))
        got_cand = ours.score_candidates(torch.from_numpy(users), torch.from_numpy(cands))
        got_pairs = ours.score_pairs(torch.from_numpy(users), torch.from_numpy(cands[:, 0]))
    ju, jc = jnp.asarray(users), jnp.asarray(cands)

    @jax.jit
    def reference(params):
        return (ref.log2feats(params, ref.ctx[ju]), ref.score_all(params, ju),
                ref.score_candidates(params, ju, jc), ref.score_pairs(params, ju, jc[:, 0]))

    for got, want in zip((feats, got_all, got_cand, got_pairs), reference(params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["pallas-interpret", "einsum"])
def test_small_sasrec_matches_reference(fused):
    n_users, n_items, maxlen = 6, 30, 20
    cfg = {"emb_dim": 64, "num_blocks": 2, "num_heads": 2, "maxlen": maxlen, "fused_attention": fused}
    rng = np.random.default_rng(0)
    ctx = rng.integers(1, n_items + 1, (n_users, maxlen)).astype(np.int32)
    ctx[np.arange(maxlen)[None, :] < rng.integers(0, maxlen, (n_users, 1))] = 0  # left padding
    ctx[0] = 0  # a user with no history
    params = JaxSASRec(cfg, n_users, n_items).init_params(jax.random.key(1))
    ref, ours = _pair(cfg, n_users, n_items, ctx, params)
    ours.fused_attention = True  # the port's kernel path (its plain version on the CPU)
    users = np.arange(n_users, dtype=np.int64)
    cands = rng.integers(0, n_items, (n_users, 7))
    _check_scores(ref, ours, params, users, cands)


def test_checkpoint_sasrec_matches_reference():
    data = JaxSequentialData(jax_load_split_data(SPLIT, n_test=1))
    cfg = {"emb_dim": 64, "num_blocks": 2, "num_heads": 2, "maxlen": 100, "fused_attention": False}
    ctx = data.eval_context(100, extra_df=data.valid[0])
    params = jax.tree_util.tree_map(jnp.asarray, jax_load_raw_checkpoint(CHECKPOINT)["params"])
    params["blocks"] = [params["blocks"][str(i)] for i in range(2)]
    ref, ours = _pair(cfg, data.n_users, data.n_items, ctx, params)
    ours.fused_attention = True
    cand = data.eval_candidates(data.test[0])
    _check_scores(ref, ours, params, cand.users.astype(np.int64), cand.items.astype(np.int64))


def test_convert_keeps_layout_and_padding_row():
    cfg = {"emb_dim": 64, "num_blocks": 2, "num_heads": 2, "maxlen": 10}
    params = JaxSASRec(cfg, 3, 12).init_params(jax.random.key(2))
    state = sasrec_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    np.testing.assert_array_equal(state["blocks.1.attn.wq"].numpy(), np.asarray(params["blocks"][1]["attn"]["wq"]))
    assert state["item_emb"].shape == (13, 64) and not state["item_emb"][0].any()
    model = SASRec(cfg, 3, 12, device="cpu")
    assert set(state) == set(model.state_dict())


def test_init_weights_follows_the_reference_initializer():
    cfg = {"emb_dim": 64, "num_blocks": 2, "num_heads": 2, "maxlen": 10}
    a = SASRec(cfg, 3, 500, device="cpu").init_weights(torch.Generator().manual_seed(7))
    b = SASRec(cfg, 3, 500, device="cpu").init_weights(torch.Generator().manual_seed(7))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    assert not a.item_emb[0].any()
    assert abs(float(a.item_emb[1:].detach().std()) - 0.1) < 0.01
    assert torch.equal(a.last_ln["scale"], torch.ones(64)) and not a.blocks[0]["ffn"]["b1"].any()
    bound = (6 / 128) ** 0.5  # Xavier-uniform limit for a (64, 64) weight
    assert float(a.blocks[1]["attn"]["wo"].abs().max()) <= bound


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((5, 7, 64)) * 3 + 1).astype(np.float32)
    scale, bias = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    x[0, 0] = 2.5  # a constant row: the variance is 0 and eps decides the result
    want = jax_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ks", [(1, 3, 5), (10, 20)], ids=["k<=C", "k>C"])
def test_ranking_metrics_with_planted_ties_match_reference(ks):
    rng = np.random.default_rng(6)
    U, C = 40, 12
    scores = rng.integers(0, 4, (U, C)).astype(np.float32)  # many exact ties
    relevance = (rng.random((U, C)) < 0.25).astype(np.float32)
    relevance[0] = 0.0  # a user with no positive
    mask = rng.random((U, C)) < 0.85
    names = ("ndcg", "precision", "recall", "map")
    want = jax_metrics.ranking_metrics(*(jnp.asarray(a) for a in (scores, relevance, mask)), names, ks)
    got = metrics.ranking_metrics(*(torch.from_numpy(a) for a in (scores, relevance, mask)), names, ks)
    assert list(got) == list(want)
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, atol=1e-7, err_msg=key)
    # ties rank the lowest slot first: only slot 0 relevant among equal scores
    flat = torch.zeros(1, 5)
    rel = torch.tensor([[1.0, 0, 0, 0, 0]])
    assert float(metrics.precision_at_k(flat, rel, torch.ones(1, 5, dtype=torch.bool), 1)) == 1.0
