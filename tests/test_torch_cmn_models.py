"""PairwiseGMF and CMN in the port against the JAX models on the same
parameters: ``build_item_neighborhoods``, scores, losses and every
parameter's gradient against ``jax.grad`` (CMN at 1-3 hops, with an item
that has no training users), CMN's blocked scoring against one call, the
warm start from PairwiseGMF's memories, the initializers against JAX's, and
the registry's names."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_mf import structured_split

from beta_recsys_tpu.models.cmn import CMN as JaxCMN
from beta_recsys_tpu.models.cmn import build_item_neighborhoods as jax_build_item_neighborhoods
from beta_recsys_tpu.models.pairwise_gmf import PairwiseGMF as JaxPairwiseGMF
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.models import MODELS, build_model, cmn, pairwise_gmf
from beta_recsys_tpu_torch.recommenders import CMN as CMNRecommender

# float32 products summed in other orders on the two sides.
RTOL, ATOL = 1e-5, 1e-6
GMF_CFG = {"model": "PairwiseGMF", "emb_dim": 12, "regs": [1e-2], "stddev": 0.3}
CMN_CFG = {"model": "CMN", "emb_dim": 12, "hops": 2, "training_l2_lambda": 0.1}
EMPTY_ITEM = 3  # an item whose training users the tests take away


@pytest.fixture(scope="module")
def data():
    return BaseData(structured_split())


def neighborhoods(data, empty_item=None):
    csr = data.user_item_csr().tolil()
    if empty_item is not None:
        csr[:, empty_item] = 0
    return csr.tocsr()


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def _scaled(params, scale):
    """Memories at a scale where the attention is not uniform."""
    return {k: (v * scale if k.endswith("memory") or k == "user_output" else v) for k, v in params.items()}


def _models(data, cfg, seed=0, empty_item=EMPTY_ITEM):
    if cfg["model"] == "CMN":
        nb, nb_len = jax_build_item_neighborhoods(neighborhoods(data, empty_item))
        artifacts, cls = {"item_neighbors": nb, "item_nb_len": nb_len}, JaxCMN
    else:
        artifacts, cls = {}, JaxPairwiseGMF
    ref = cls(cfg, data.n_users, data.n_items, artifacts)
    params = ref.init_params(jax.random.key(seed))
    if cfg["model"] == "CMN":
        params = _scaled(params, 30.0)
    ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    return ref, params, ours


def _batch(data, seed=0, size=48):
    rng = np.random.default_rng(seed)
    batch = {"users": rng.integers(0, data.n_users, size), "pos_items": rng.integers(0, data.n_items, size),
             "neg_items": rng.integers(0, data.n_items, size)}
    batch["pos_items"][:3] = EMPTY_ITEM
    return batch


def test_build_item_neighborhoods_matches_jax(data):
    for csr in (neighborhoods(data), neighborhoods(data, EMPTY_ITEM)):
        for cap in (None, 5):
            got = cmn.build_item_neighborhoods(csr, cap)
            want = jax_build_item_neighborhoods(csr, cap)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
    nb, nb_len = cmn.build_item_neighborhoods(neighborhoods(data, EMPTY_ITEM))
    assert nb_len[EMPTY_ITEM] == 0 and not nb[EMPTY_ITEM].any()


@pytest.mark.parametrize("cfg", [GMF_CFG, dict(CMN_CFG, hops=1), CMN_CFG, dict(CMN_CFG, hops=3)],
                         ids=["PairwiseGMF", "CMN-1", "CMN-2", "CMN-3"])
def test_scores_match_jax(data, cfg):
    ref, params, ours = _models(data, cfg)
    rng = np.random.default_rng(1)
    users, items = rng.integers(0, data.n_users, 30), rng.integers(0, data.n_items, 30)
    items[:2] = EMPTY_ITEM
    cand = rng.integers(0, data.n_items, (30, 7))
    cand[0, :3] = EMPTY_ITEM
    with torch.no_grad():
        got = (ours.score_pairs(torch.as_tensor(users), torch.as_tensor(items)),
               ours.score_candidates(torch.as_tensor(users), torch.as_tensor(cand)),
               ours.score_all(torch.as_tensor(users)))
    want = (ref.score_pairs(params, users, items), ref.score_candidates(params, users, cand),
            ref.score_all(params, users))
    for what, g, w in zip(("pairs", "candidates", "all"), got, want):
        assert g.shape == w.shape and np.isfinite(g.numpy()).all()
        _close(g, w, what)


@pytest.mark.parametrize("cfg", [GMF_CFG, dict(CMN_CFG, hops=1), CMN_CFG, dict(CMN_CFG, hops=3)],
                         ids=["PairwiseGMF", "CMN-1", "CMN-2", "CMN-3"])
def test_loss_and_gradients_match_jax(data, cfg):
    ref, params, ours = _models(data, cfg)
    batch = _batch(data)
    want_loss, want_grads = jax.value_and_grad(ref.loss)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                                         jax.random.key(0))
    loss = ours.loss({k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    _close(loss, want_loss, "loss")
    want_grads = flatten_params(jax.tree_util.tree_map(np.asarray, want_grads))
    grads = {name: p.grad for name, p in ours.named_parameters()}
    assert set(grads) == set(want_grads)
    for name, grad in grads.items():
        _close(grad, want_grads[name], name)


def test_an_item_without_users_attends_uniformly_and_stays_finite(data):
    _, _, ours = _models(data, CMN_CFG)
    users = torch.arange(4)
    items = torch.full((4,), EMPTY_ITEM)
    with torch.no_grad():
        o = ours._memory_attention(users, items)
        # Every slot scores -1e30: the softmax is uniform over the padding (user 0).
        torch.testing.assert_close(o, ours.user_output[0].expand(4, -1), rtol=1e-6, atol=1e-7)
    assert torch.isfinite(ours.loss({"users": users, "pos_items": items, "neg_items": items + 1})).item()


@pytest.mark.parametrize("block_bytes", [1, 7 * 2 * 13 * 12 * 4, 8 * 2 * 13 * 12 * 4, 1 << 30])
def test_blocked_scoring_equals_one_call(data, monkeypatch, block_bytes):
    """Outside autograd the pairs are scored in blocks; every block size
    gives the scores of one call on all the pairs: bit for bit where the
    block is a multiple of 8 pairs, else to the last bit or two (the CPU's
    products round a row count that is not a multiple of its vector width
    in another order)."""
    _, _, ours = _models(data, CMN_CFG)
    assert ours.item_neighbors.shape[1] == 13  # the block sizes above are in pairs of this split's M
    rng = np.random.default_rng(3)
    users = torch.as_tensor(rng.integers(0, data.n_users, 40))
    cand = torch.as_tensor(rng.integers(0, data.n_items, (40, 9)))
    with torch.enable_grad():
        whole = ours.score_candidates(users, cand).detach()
    monkeypatch.setattr(cmn, "SCORE_BLOCK_BYTES", block_bytes)
    with torch.no_grad():
        blocked = ours.score_candidates(users, cand)
        pairs = ours.score_pairs(users[:, None].expand(cand.shape), cand)
        assert ours.score_pairs(users[:0], users[:0]).shape == (0,)
    for got in (blocked, pairs):
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-7)
    if max(1, block_bytes // (2 * 13 * 12 * 4)) % 8 == 0:
        assert torch.equal(blocked, whole)


def test_the_warm_start_copies_the_memories_bit_for_bit(data):
    gmf = build_model(dict(GMF_CFG, emb_dim=12), data.n_users, data.n_items, device="cpu")
    gmf.init_weights(torch.Generator().manual_seed(4))
    rec = CMNRecommender({"model": CMN_CFG}, user_embeddings=gmf.user_memory, item_embeddings=gmf.item_memory.
                         detach().numpy(), device="cpu")
    rec.init(data, torch.Generator().manual_seed(5))
    assert torch.equal(rec.model.user_memory, gmf.user_memory) and torch.equal(rec.model.item_memory,
                                                                               gmf.item_memory)
    cold = CMNRecommender({"model": CMN_CFG}, device="cpu").init(data, torch.Generator().manual_seed(5))
    assert not torch.equal(cold.model.user_memory, gmf.user_memory)
    for name in ("user_output", "dense_w", "out_w", "hop_maps.0.w"):
        assert torch.equal(rec.model.state_dict()[name], cold.model.state_dict()[name]), name


def _in_distribution(got, want, bound, what):
    """Both draws within ``bound``; the port's std within 5 standard errors
    of JAX's draw's, its mean within 5 of 0."""
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    assert np.abs(got).max() <= bound * (1 + 1e-6) and np.abs(want).max() <= bound * (1 + 1e-6), what
    se = want.std() * np.sqrt(2.0 / min(got.size, want.size))
    assert abs(got.std() - want.std()) < 5 * se, (what, got.std(), want.std())
    assert abs(got.mean()) < 5 * want.std() / np.sqrt(got.size), what


def test_initializers_in_distribution_as_jax(data):
    """Truncated normal (0.01, cut at +-0.02) memories, He-normal (a normal
    cut at +-2 of its scale, std sqrt(2 / fan_in)) dense and hop weights,
    ones for their biases, Xavier-uniform ``v`` and ``out_w``."""
    d = 50
    cfg = dict(CMN_CFG, emb_dim=d)
    nb, nb_len = cmn.build_item_neighborhoods(neighborhoods(data))
    art = {"item_neighbors": nb, "item_nb_len": nb_len}
    ours = build_model(cfg, data.n_users, data.n_items, art, device="cpu").init_weights(torch.Generator()
                                                                                        .manual_seed(0))
    want = JaxCMN(cfg, data.n_users, data.n_items, art).init_params(jax.random.key(0))
    he = {n: 2 * np.sqrt(2.0 / n) / 0.87962566103423978 for n in (d, 2 * d)}
    for name, bound in (("user_memory", 0.02), ("item_memory", 0.02), ("user_output", 0.02),
                        ("dense_w", he[2 * d]), ("out_w", np.sqrt(6.0 / (d + 1)))):
        _in_distribution(getattr(ours, name).detach().numpy(), want[name], bound, name)
    _in_distribution(ours.hop_maps[0]["w"].detach().numpy(), want["hop_maps"][0]["w"], he[d], "hop_maps.0.w")
    std = np.sqrt(2.0 / (2 * d))
    assert abs(float(ours.dense_w.detach().std()) - std) < 5 * std / np.sqrt(2 * ours.dense_w.numel())
    assert torch.equal(ours.dense_b, torch.ones(d)) and torch.equal(ours.hop_maps[0]["b"], torch.ones(d))
    gcfg = dict(GMF_CFG, stddev=0.01, emb_dim=d)
    gmf = build_model(gcfg, data.n_users, data.n_items, device="cpu").init_weights(torch.Generator().manual_seed(0))
    want = JaxPairwiseGMF(gcfg, data.n_users, data.n_items).init_params(jax.random.key(0))
    for name, bound in (("user_memory", 0.02), ("item_memory", 0.02), ("v", np.sqrt(6.0 / (d + 1)))):
        _in_distribution(getattr(gmf, name).detach().numpy(), want[name], bound, name)


def test_registry_holds_the_jax_names(data):
    nb, nb_len = cmn.build_item_neighborhoods(neighborhoods(data))
    art = {"item_neighbors": nb, "item_nb_len": nb_len}
    for name, cls in (("PairwiseGMF", pairwise_gmf.PairwiseGMF), ("CMN", cmn.CMN), ("cmn", cmn.CMN)):
        assert MODELS[name] is cls
        model = build_model({"model": name}, data.n_users, data.n_items, art, device="cpu")
        assert isinstance(model, cls) and model.batch_kind == "pairwise"
    with pytest.raises(ValueError, match="artifacts\\['item_neighbors'\\]"):
        build_model({"model": "CMN"}, data.n_users, data.n_items, device="cpu")
