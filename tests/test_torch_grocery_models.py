"""Triple2vec, VBCAR and TVBR in the port against the JAX package at a small
size: the loss and every gradient (``jax.value_and_grad``) on the same
batch and, for VBCAR and TVBR, the same latent noise (the JAX keys' draws
handed to the port's ``latent_noise``), Triple2vec with tied and untied
item tables, VBCAR under tanh and without an activation, TVBR at time
buckets 0 and ``time_step - 1``; ``user_item_embeddings`` and the candidate
scores; the initializers in distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beta_recsys_tpu.models.triple2vec import Triple2vec as JaxTriple2vec
from beta_recsys_tpu.models.tvbr import TVBR as JaxTVBR
from beta_recsys_tpu.models.vbcar import VBCAR as JaxVBCAR
from beta_recsys_tpu_torch.convert import flatten_params, triple2vec_params_from_jax, tvbr_params_from_jax
from beta_recsys_tpu_torch.convert import vbcar_params_from_jax
from beta_recsys_tpu_torch.models import build_model
from beta_recsys_tpu_torch.models import vbcar as port_vbcar
from beta_recsys_tpu_torch.models.triple2vec import Triple2vec
from beta_recsys_tpu_torch.models.tvbr import TVBR
from beta_recsys_tpu_torch.models.vbcar import VBCAR

RTOL, ATOL = 1e-5, 1e-6  # float32 sums in other orders
N_USERS, N_ITEMS, B, N_NEG, D, LATE, F_U, F_I = 13, 21, 9, 3, 8, 6, 5, 7
JAX_MODELS = {"Triple2vec": JaxTriple2vec, "VBCAR": JaxVBCAR, "TVBR": JaxTVBR}
PORT_MODELS = {"Triple2vec": Triple2vec, "VBCAR": VBCAR, "TVBR": TVBR}
CONVERT = {"Triple2vec": triple2vec_params_from_jax, "VBCAR": vbcar_params_from_jax, "TVBR": tvbr_params_from_jax}


def _artifacts(seed=0):
    rng = np.random.default_rng(seed)
    return {"user_fea": rng.normal(size=(N_USERS, F_U)).astype(np.float32),
            "item_fea": rng.normal(size=(N_ITEMS, F_I)).astype(np.float32)}


def _config(name, **model):
    cfg = {"model": name, "emb_dim": D, "n_neg": N_NEG}
    if name != "Triple2vec":
        cfg.update(late_dim=LATE, alpha=0.3, activator="tanh", time_step=3)
    return {**cfg, **model}


def _batch(seed, t=None, time_step=3):
    rng = np.random.default_rng(seed)
    batch = {"users": rng.integers(0, N_USERS, B), "item1": rng.integers(0, N_ITEMS, B),
             "item2": rng.integers(0, N_ITEMS, B), "neg_users": rng.integers(0, N_USERS, (B, N_NEG)),
             "neg_item1": rng.integers(0, N_ITEMS, (B, N_NEG)), "neg_item2": rng.integers(0, N_ITEMS, (B, N_NEG))}
    batch["users"][:2] = 4  # repeated ids: their gradients add up
    batch["neg_item1"][0] = batch["item1"][0]
    if t is not None:
        batch["t"] = np.full(B, t) if t != "mixed" else rng.integers(0, time_step, B)
    return batch


def _scaled(params, seed):
    """The params with every leaf redrawn at scale 0.3 (the initial ±0.01
    tables would leave the skip-gram's products at ~1e-4)."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    return jax.tree_util.tree_unflatten(tree, [0.3 * jax.random.normal(k, x.shape) for k, x in zip(keys, leaves)])


def _pair(name, seed=0, **model):
    """(cfg, JAX model, params, port model holding the same params)."""
    cfg = _config(name, **model)
    art = _artifacts() if name != "Triple2vec" else None
    ref = JAX_MODELS[name](cfg, N_USERS, N_ITEMS, art)
    params = _scaled(ref.init_params(jax.random.key(seed)), seed + 1)
    ours = PORT_MODELS[name](cfg, N_USERS, N_ITEMS, art, device="cpu")
    ours.load_state_dict(CONVERT[name](jax.tree_util.tree_map(np.asarray, params)))
    return cfg, ref, params, ours


def _jax_noise(batch, rng):
    """The six standard-normal draws of the JAX loss's ``_sample`` calls."""
    keys = jax.random.split(rng, 6)
    shapes = [(B, D)] * 3 + [(B, N_NEG, D)] * 3
    return [torch.from_numpy(np.array(jax.random.normal(k, s))) for k, s in zip(keys, shapes)]


def _check(ours, ref, params, batch, rng, monkeypatch=None):
    want_loss, want_grads = jax.value_and_grad(ref.loss)(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    generator = None
    if monkeypatch is not None:
        noise = _jax_noise(batch, rng)
        monkeypatch.setattr(port_vbcar, "latent_noise", lambda gen, shape, device: noise.pop(0))
        generator = torch.Generator().manual_seed(0)
    loss = ours.loss({k: torch.as_tensor(v) for k, v in batch.items()}, generator)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL, atol=ATOL)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(want) == {name for name, _ in ours.named_parameters()}
    for name, p in ours.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
    if monkeypatch is not None:
        assert not noise  # six draws, each taken once
    return want


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_triple2vec_loss_and_gradients_match_jax(tied, seed):
    _, ref, params, ours = _pair("Triple2vec", seed, use_bias=tied)
    want = _check(ours, ref, params, _batch(seed), jax.random.key(seed))
    if tied:  # the untied table exists, gets no gradient and no optimizer moment
        assert ours.item_emb2.grad is None and not want["item_emb2"].any()


@pytest.mark.parametrize("activator", ["tanh", "identity", "lrelu"])
def test_vbcar_loss_and_gradients_match_jax(activator, monkeypatch):
    _, ref, params, ours = _pair("VBCAR", 2, activator=activator)
    _check(ours, ref, params, _batch(2), jax.random.key(5), monkeypatch)


@pytest.mark.parametrize("t", [0, 2, "mixed"])
def test_tvbr_loss_and_gradients_match_jax(t, monkeypatch):
    """Time buckets 0 (whose prior is bucket 0 itself), time_step - 1 and a
    mix of every bucket."""
    _, ref, params, ours = _pair("TVBR", 3)
    _check(ours, ref, params, _batch(3, t=t), jax.random.key(6), monkeypatch)


def test_the_loss_needs_a_generator_for_its_noise():
    _, _, _, ours = _pair("VBCAR")
    with pytest.raises(ValueError, match="generator"):
        ours.loss({k: torch.as_tensor(v) for k, v in _batch(0).items()})


@pytest.mark.parametrize("name,model", [("Triple2vec", {"use_bias": True}), ("Triple2vec", {"use_bias": False}),
                                        ("VBCAR", {}), ("TVBR", {})])
def test_embeddings_and_scores_match_jax(name, model):
    """``user_item_embeddings`` (TVBR's at bucket ``time_step``, one past
    training's), candidate scores and full-catalog scores."""
    _, ref, params, ours = _pair(name, 4, **model)
    want_u, want_i = ref.user_item_embeddings(params)
    with torch.no_grad():
        got_u, got_i = ours.user_item_embeddings()
        users = torch.tensor([0, 5, 12])
        cand = torch.tensor([[1, 2, 20], [0, 0, 7], [19, 3, 4]])
        scores = ours.score_candidates(users, cand)
        full = ours.score_all(users)
    np.testing.assert_allclose(got_u.detach().numpy(), np.asarray(want_u), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_i.detach().numpy(), np.asarray(want_i), rtol=RTOL, atol=ATOL)
    want_scores = ref.score_candidates(params, jnp.asarray(users.numpy()), jnp.asarray(cand.numpy()))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=RTOL, atol=ATOL)
    want_full = ref.score_all(params, jnp.asarray(users.numpy()))
    np.testing.assert_allclose(full.numpy(), np.asarray(want_full)[:, :N_ITEMS], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["Triple2vec", "VBCAR", "TVBR"])
def test_initializers_match_jax_in_distribution(name):
    """The port's initial tables and layers against the JAX initializer's at
    a larger size: the same names and shapes, means and standard deviations
    within 5 standard errors, the tables' bounds, zero biases, and the
    same bits from the same generator seed."""
    n_users, n_items = 400, 500
    cfg = _config(name)
    rng = np.random.default_rng(0)
    art = None if name == "Triple2vec" else {"user_fea": rng.normal(size=(n_users, 40)).astype(np.float32),
                                             "item_fea": rng.normal(size=(n_items, 40)).astype(np.float32)}
    want = flatten_params(jax.tree_util.tree_map(
        np.asarray, JAX_MODELS[name](cfg, n_users, n_items, art).init_params(jax.random.key(0))))
    model = build_model(cfg, n_users, n_items, art, device="cpu")
    got = dict(model.init_weights(torch.Generator().manual_seed(0)).state_dict())
    again = dict(build_model(cfg, n_users, n_items, art, device="cpu").init_weights(
        torch.Generator().manual_seed(0)).state_dict())
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and torch.equal(g, again[key]), key
        if not w.any():
            assert not g.any(), key
            continue
        se = float(w.std()) / np.sqrt(w.numel())
        assert abs(float(g.mean()) - float(w.mean())) < 5 * np.sqrt(2) * se, key
        assert abs(float(g.std()) - float(w.std())) < 5 * float(w.std()) / np.sqrt(w.numel() / 2), key
        if key in ("user_emb", "item_emb", "item_emb1", "item_emb2"):
            bound = 0.01 if name == "Triple2vec" else 0.1 / np.sqrt(D)
            assert float(g.abs().max()) <= bound and float(w.abs().max()) <= bound
