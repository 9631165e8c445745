"""SimGCL, SGL, BUIR and LCFN in the port against the JAX models on the same
parameters: scores (pairs, candidates, the full catalog), losses and every
parameter's gradient against ``jax.grad`` at 1-2 layers, emb 8-16, with the
same draws on both sides (SGL's augmented subgraphs at every ``ssl_mode``
and ``aug_type``, SimGCL's noise; each side's draw monkeypatched), SimGCL
without perturbation, BUIR's target EMA (``post_update``), its two-product
scores and ``score_pairs`` raising on both sides, LCFN over one (P, Q) for
both, the initializers in distribution against JAX's, and the registry's
names."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_mf import structured_split

import beta_recsys_tpu.models.sgl as jax_sgl
from beta_recsys_tpu.models.buir import BUIR as JaxBUIR
from beta_recsys_tpu.models.lcfn import LCFN as JaxLCFN
from beta_recsys_tpu.models.sgl import SGL as JaxSGL
from beta_recsys_tpu.models.simgcl import SimGCL as JaxSimGCL
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.models import MODELS, build_model, buir, lcfn, sgl, simgcl
from beta_recsys_tpu_torch.ops.graph import undirected_pairs

# float32 propagations and products summed in other orders on the two sides.
RTOL, ATOL = 1e-5, 1e-6
CONFIGS = {
    "SimGCL": {"model": "SimGCL", "emb_dim": 16, "n_layer": 2, "eps": 0.1, "reg": 1e-2, "lambda": 0.5,
               "temperature": 0.2},
    "SGL": {"model": "SGL", "emb_dim": 8, "n_layers": 2, "regs": [1e-2], "ssl_reg": 0.1, "ssl_temp": 0.2,
            "ssl_ratio": 0.3},
    "BUIR": {"model": "BUIR", "emb_dim": 16, "n_layers": 2, "momentum": 0.9},
    "LCFN-1": {"model": "LCFN", "emb_dim": 16, "layer": 1, "lamda": 1e-2, "cut_off": 0.2},
    "LCFN-2": {"model": "LCFN", "emb_dim": 8, "layer": 2, "lamda": 1e-2, "cut_off": 0.2},
}
JAX_MODELS = {"SimGCL": JaxSimGCL, "SGL": JaxSGL, "BUIR": JaxBUIR, "LCFN": JaxLCFN}


@pytest.fixture(scope="module")
def data():
    return BaseData(structured_split())


def artifacts_for(data, cfg):
    if cfg["model"] == "LCFN":
        return {"graph_embeddings": data.get_graph_embeddings(cfg["cut_off"])}
    return {"adj": data.get_norm_adj("sym")}


def _models(data, key, seed=0, fmt="dense", **extra):
    """(JAX model, its params, the port's model on the same params)."""
    cfg = dict(CONFIGS[key], graph_format=fmt, **extra)
    artifacts = artifacts_for(data, cfg)
    ref = JAX_MODELS[cfg["model"]](cfg, data.n_users, data.n_items, artifacts)
    params = ref.init_params(jax.random.key(seed))
    ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    return ref, params, ours


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def _batch(data, seed=0, size=48):
    rng = np.random.default_rng(seed)
    return {"users": rng.integers(0, data.n_users, size), "pos_items": rng.integers(0, data.n_items, size),
            "neg_items": rng.integers(0, data.n_items, size)}


@pytest.mark.parametrize("key", ["SimGCL", "SGL", "LCFN-1", "LCFN-2"])
def test_scores_match_jax(data, key):
    ref, params, ours = _models(data, key)
    rng = np.random.default_rng(1)
    users, items = rng.integers(0, data.n_users, 30), rng.integers(0, data.n_items, 30)
    cand = rng.integers(0, data.n_items, (30, 7))
    with torch.no_grad():
        got = (ours.score_pairs(torch.as_tensor(users), torch.as_tensor(items)),
               ours.score_candidates(torch.as_tensor(users), torch.as_tensor(cand)),
               ours.score_all(torch.as_tensor(users)))
        tables = ours.user_item_embeddings()
    want = jax.jit(lambda p: (ref.score_pairs(p, users, items), ref.score_candidates(p, users, cand),
                              ref.score_all(p, users), ref.user_item_embeddings(p)))(params)
    for what, g, w in zip(("pairs", "candidates", "all"), got, want):
        assert g.shape == w.shape
        _close(g, w, what)
    for g_tab, w_tab in zip(tables, want[3]):
        _close(g_tab, w_tab)


def test_buir_scores_are_two_products_and_pairs_raise_on_both_sides(data):
    ref, params, ours = _models(data, "BUIR")
    with torch.no_grad():  # a target apart from the online encoder must not enter the scores
        ours.target["user_emb"].mul_(3.0)
    params = {**params, "target": {k: v * 3.0 for k, v in params["target"].items()}}
    rng = np.random.default_rng(1)
    users, cand = rng.integers(0, data.n_users, 30), rng.integers(0, data.n_items, (30, 7))
    with torch.no_grad():
        _close(ours.score_candidates(torch.as_tensor(users), torch.as_tensor(cand)),
               ref.score_candidates(params, users, cand), "candidates")
        _close(ours.score_all(torch.as_tensor(users)), ref.score_all(params, users), "all")
        with pytest.raises(NotImplementedError):
            ours.score_pairs(torch.as_tensor(users), torch.as_tensor(users))
    with pytest.raises(NotImplementedError):
        ref.score_pairs(params, users, users)
    assert ours.user_item_embeddings() is None and ref.user_item_embeddings(params) is None


def test_buir_holds_its_four_tables_once(data, monkeypatch):
    _, _, ours = _models(data, "BUIR")
    calls = []
    real = ours._encode
    monkeypatch.setattr(ours, "_encode", lambda enc: calls.append(1) or real(enc))
    users = torch.arange(data.n_users)
    with torch.no_grad():
        want = ours.score_all(users)
        assert len(calls) == 1
        with ours.holding_embeddings():
            got = torch.cat([ours.score_all(users[:20]), ours.score_all(users[20:])])
            ours.score_candidates(users[:5], torch.zeros(5, 3, dtype=torch.long))
        assert len(calls) == 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _port_grads(ours, batch, generator):
    ours.zero_grad(set_to_none=True)
    loss = ours.loss({k: torch.as_tensor(v) for k, v in batch.items()}, generator)
    loss.backward()
    return loss, {name: p.grad for name, p in ours.named_parameters() if p.requires_grad}


def _check_loss_and_grads(data, ref, params, ours, rng_key, generator):
    batch = _batch(data)
    # jit: one compilation instead of an eager dispatch of every operation.
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rng_key)
    loss, grads = _port_grads(ours, batch, generator)
    _close(loss, want_loss, "loss")
    want_grads = flatten_params(jax.tree_util.tree_map(np.asarray, want_grads))
    for name in set(want_grads) - set(grads):  # what takes no gradient in the port takes a zero one in JAX
        assert name.startswith("target.") and not want_grads[name].any(), name
    assert set(grads) <= set(want_grads)
    for name, grad in grads.items():
        _close(grad, want_grads[name], name)


def np_sgl_values(draws, rows, cols, edge_pair, n, aug_type, ratio):
    """SGL's renormalized kept-subgraph values in numpy, from the draws."""
    keep = (draws[rows] >= ratio) & (draws[cols] >= ratio) if aug_type == 0 else draws[edge_pair] >= ratio
    ones = keep.astype(np.float64)
    deg = np.bincount(rows, weights=ones, minlength=n)
    d_inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    return (ones * d_inv_sqrt[rows] * d_inv_sqrt[cols]).astype(np.float32)


def inject_sgl_draws(monkeypatch, data, ours, n_views, seed=7):
    """Both sides take the same ``n_views`` subgraphs, in call order: the
    port's draws, and JAX's ``sgl_augment`` the values of those draws."""
    rows, cols, _ = data.get_norm_adj("sym")
    edge_pair, n_pairs = undirected_pairs(rows, cols)
    n = data.n_users + data.n_items
    rng = np.random.default_rng(seed)
    draws = [rng.uniform(size=n if ours.aug_type == 0 else n_pairs).astype(np.float32) for _ in range(n_views)]
    values = [np_sgl_values(d, rows, cols, edge_pair, n, ours.aug_type, ours.ssl_ratio) for d in draws]
    port_draws, jax_values = itertools.cycle(draws), itertools.cycle(values)
    calls = []
    monkeypatch.setattr(sgl, "sgl_draws", lambda gen, size, device: calls.append(size) or torch.as_tensor(
        next(port_draws)))
    monkeypatch.setattr(jax_sgl, "sgl_augment", lambda *a: jnp.asarray(next(jax_values)))
    return calls


@pytest.mark.parametrize("ssl_mode,aug_type", [("user_side", 1), ("item_side", 1), ("both_side", 1), ("merge", 1),
                                               ("both_side", 0), ("merge", 0), ("both_side", 2), ("user_side", 2)])
def test_sgl_with_the_same_subgraphs_matches_jax(data, monkeypatch, ssl_mode, aug_type):
    ref, params, ours = _models(data, "SGL", ssl_mode=ssl_mode, aug_type=aug_type)
    n_views = 2 * (ours.n_layers if aug_type == 2 else 1)
    calls = inject_sgl_draws(monkeypatch, data, ours, n_views)
    _check_loss_and_grads(data, ref, params, ours, jax.random.key(0), torch.Generator())
    assert len(calls) == n_views  # two views; random walk draws each layer anew


def test_sgl_on_the_sparse_route_matches_jax(data, monkeypatch):
    ref, params, ours = _models(data, "SGL", fmt="chunked", aug_type=1)
    assert ours.prop.format == "csr"
    inject_sgl_draws(monkeypatch, data, ours, 2)
    _check_loss_and_grads(data, ref, params, ours, jax.random.key(0), torch.Generator())


def test_sgl_builds_a_dense_operator_once_a_view_or_once_a_layer(data, monkeypatch):
    for aug_type, want in ((1, 1 + 2), (2, 1 + 2 * 2)):
        _, _, ours = _models(data, "SGL", aug_type=aug_type)
        built = []
        real = ours.prop.operator
        monkeypatch.setattr(ours.prop, "operator", lambda vals=None: built.append(vals is not None) or real(vals))
        ours.loss({k: torch.as_tensor(v) for k, v in _batch(data).items()}, torch.Generator().manual_seed(0))
        assert len(built) == want and sum(built) == want - 1  # the main propagation uses the packed A


def test_sgl_rejects_an_unknown_ssl_mode(data):
    with pytest.raises(ValueError, match="Invalid ssl_mode"):
        _models(data, "SGL", ssl_mode="cross")


def test_simgcl_with_the_same_noise_matches_jax(data, monkeypatch):
    ref, params, ours = _models(data, "SimGCL")
    n, d = data.n_users + data.n_items, ours.emb_dim
    rng = np.random.default_rng(9)
    noise = [rng.uniform(size=(n, d)).astype(np.float32) for _ in range(2 * ours.n_layers)]
    port_noise, jax_noise = iter(noise), iter(noise)
    monkeypatch.setattr(simgcl, "perturbation_noise", lambda gen, shape, device: torch.as_tensor(next(port_noise)))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(next(jax_noise)))
    _check_loss_and_grads(data, ref, params, ours, jax.random.key(0), torch.Generator())
    assert next(port_noise, None) is None and next(jax_noise, None) is None


def test_simgcl_without_perturbation_matches_jax(data):
    """eps 0: JAX's views add zero noise; the port's views without a
    generator are not perturbed at all."""
    ref, params, ours = _models(data, "SimGCL", eps=0.0)
    _check_loss_and_grads(data, ref, params, ours, jax.random.key(0), None)


def test_simgcl_noise_in_distribution(data, monkeypatch):
    """A training loss draws U[0, 1) noise of the table's shape once a
    layer of each of two views; scoring draws none."""
    _, _, ours = _models(data, "SimGCL")
    drawn = []
    real = simgcl.perturbation_noise
    monkeypatch.setattr(simgcl, "perturbation_noise", lambda gen, shape, device: drawn.append(
        real(gen, shape, device)) or drawn[-1])
    batch = {k: torch.as_tensor(v) for k, v in _batch(data).items()}
    for _ in range(5):
        ours.loss(batch, torch.Generator().manual_seed(len(drawn)))
    with torch.no_grad():
        ours.score_all(torch.arange(data.n_users))
    assert len(drawn) == 5 * 2 * ours.n_layers
    x = torch.cat([d.reshape(-1) for d in drawn])
    assert x.min() >= 0 and x.max() < 1
    assert abs(float(x.mean()) - 0.5) < 5 * np.sqrt(1 / 12 / x.numel())


@pytest.mark.parametrize("fmt", ["dense", "chunked"])
def test_buir_loss_and_gradients_match_jax(data, fmt):
    ref, params, ours = _models(data, "BUIR", fmt=fmt)
    with torch.no_grad():
        ours.target["item_emb"].mul_(0.5)
    params = {**params, "target": {**params["target"], "item_emb": params["target"]["item_emb"] * 0.5}}
    _check_loss_and_grads(data, ref, params, ours, jax.random.key(0), None)
    assert all(p.grad is None for p in ours.target.values())


def test_buir_post_update_matches_jax(data):
    ref, params, ours = _models(data, "BUIR")
    params = {**params, "online": {k: v + 0.01 for k, v in params["online"].items()}}
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    before = {k: v.clone() for k, v in ours.state_dict().items()}
    want = flatten_params(jax.tree_util.tree_map(np.asarray, ref.post_update(params)))
    ours.post_update()
    for name, value in ours.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name], rtol=1e-6, atol=1e-7, err_msg=name)
        if not name.startswith("target."):
            assert torch.equal(value, before[name]), name
    assert not torch.equal(ours.target["user_emb"], before["target.user_emb"])


@pytest.mark.parametrize("key", ["LCFN-1", "LCFN-2"])
def test_lcfn_loss_and_gradients_match_jax(data, key):
    ref, params, ours = _models(data, key)
    _check_loss_and_grads(data, ref, params, ours, jax.random.key(0), None)


def test_registry_holds_the_jax_names(data):
    adj = {"adj": data.get_norm_adj("sym")}
    for name, cls in (("SGL", sgl.SGL), ("sgl", sgl.SGL), ("SimGCL", simgcl.SimGCL), ("simgcl", simgcl.SimGCL),
                      ("BUIR", buir.BUIR), ("buir", buir.BUIR)):
        assert MODELS[name] is cls
        assert isinstance(build_model({"model": name}, data.n_users, data.n_items, adj, device="cpu"), cls)
        with pytest.raises(ValueError, match="artifacts\\['adj'\\]"):
            build_model({"model": name}, data.n_users, data.n_items, device="cpu")
    emb = {"graph_embeddings": data.get_graph_embeddings(0.2)}
    for name in ("LCFN", "lcfn"):
        assert MODELS[name] is lcfn.LCFN
        assert isinstance(build_model({"model": name}, data.n_users, data.n_items, emb, device="cpu"), lcfn.LCFN)
    with pytest.raises(ValueError, match="graph_embeddings"):
        build_model({"model": "LCFN"}, data.n_users, data.n_items, adj, device="cpu")


def _same_distribution(got, want, what):
    """Mean and std of ``got`` within 5 standard errors of ``want``'s (the
    standard errors of the two samples' difference)."""
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    var = got.var() / got.size + want.var() / want.size
    assert abs(got.mean() - want.mean()) < 5 * np.sqrt(var), (what, got.mean(), want.mean())
    se_std = np.sqrt(got.var() / (2 * got.size) + want.var() / (2 * want.size))
    assert abs(got.std() - want.std()) < 5 * se_std, (what, got.std(), want.std())


@pytest.mark.parametrize("key", ["SimGCL", "SGL", "BUIR", "LCFN-2"])
def test_initializers_in_distribution_as_jax(data, key):
    """Each parameter of the port's initializer against JAX's draw of it
    (xavier tables and weights, BUIR's target the online copy and a zero
    bias; LCFN's tables, filters, and transformers off and on the
    diagonal); one seed draws one model."""
    ref, params, ours = _models(data, key)
    ours.init_weights(torch.Generator().manual_seed(3))
    state = ours.state_dict()
    want = flatten_params(jax.tree_util.tree_map(np.asarray, params))
    assert set(state) == set(want)
    for name, value in state.items():
        got, ref_value = value.numpy(), want[name].numpy()
        if name == "pred_b":
            assert not got.any() and not ref_value.any()
        elif name.startswith("target."):
            assert np.array_equal(got, state["online." + name[len("target."):]].numpy())
        elif name.startswith("transformers."):
            off = ~np.eye(got.shape[0], dtype=bool)
            _same_distribution(got[off], ref_value[off], name + " off the diagonal")
            _same_distribution(np.diag(got), np.diag(ref_value), name + " diagonal")
        else:
            _same_distribution(got, ref_value, name)
    again = build_model(ours.config, data.n_users, data.n_items, ours.artifacts, device="cpu")
    again.init_weights(torch.Generator().manual_seed(3))
    for name, value in again.state_dict().items():
        assert torch.equal(value, state[name]), name
