"""LightGCN and NGCF in the port against the JAX models on the same
parameters: scores (pairs, candidates, the full catalog) through the dense
and the sparse route, losses and every parameter's gradient against
``jax.grad`` with dropout off and with the same explicit dropout (LightGCN's
dropped edge values, NGCF's message masks), at 2 and 3 layers; the dropouts
in distribution; the registry's names; and the factorized scoring contract
(one propagation inside ``holding_embeddings``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_mf import structured_split

import beta_recsys_tpu.models.lightgcn as jax_lightgcn
from beta_recsys_tpu.models.lightgcn import LightGCN as JaxLightGCN
from beta_recsys_tpu.models.ngcf import NGCF as JaxNGCF
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.models import MODELS, build_model, lightgcn, ngcf
from beta_recsys_tpu_torch.models.base import RecModel
from beta_recsys_tpu_torch.ops import attention

# float32 propagations and products summed in other orders on the two sides.
RTOL, ATOL = 1e-5, 1e-6
CONFIGS = {
    "LightGCN-3": ("LightGCN", {"emb_dim": 16, "layer_size": [16, 16, 16], "keep_pro": 0.6, "regs": [1e-2]}),
    "LightGCN-2": ("LightGCN", {"emb_dim": 8, "layer_size": [8, 8], "keep_pro": 0.6, "regs": [1e-2]}),
    "NGCF-3": ("NGCF", {"emb_dim": 16, "layer_size": [16, 16, 16], "mess_dropout": [0.1, 0.2, 0.1], "regs": [1e-2]}),
    "NGCF-2": ("NGCF", {"emb_dim": 8, "layer_size": [16, 8], "mess_dropout": [0.3, 0.1], "regs": [1e-2]}),
}
JAX_MODELS = {"LightGCN": JaxLightGCN, "NGCF": JaxNGCF}
ADJ_VARIANT = {"LightGCN": "row_selfloop", "NGCF": "row"}


@pytest.fixture(scope="module")
def data():
    train, valid, test = structured_split()
    return BaseData((train, valid, test))


def _models(data, key, fmt="dense", seed=0):
    """(JAX model, its params, the port's model on the same params)."""
    name, extra = CONFIGS[key]
    cfg = {"model": name, "graph_format": fmt, **extra}
    artifacts = {"adj": data.get_norm_adj(ADJ_VARIANT[name])}
    ref = JAX_MODELS[name](cfg, data.n_users, data.n_items, artifacts)
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


@pytest.mark.parametrize("fmt", ["dense", "chunked"])
@pytest.mark.parametrize("key", list(CONFIGS))
def test_scores_match_jax(data, key, fmt):
    ref, params, ours = _models(data, key, fmt)
    rng = np.random.default_rng(1)
    users = rng.integers(0, data.n_users, 30)
    items = rng.integers(0, data.n_items, 30)
    cand = rng.integers(0, data.n_items, (30, 7))
    with torch.no_grad():
        got = (ours.score_pairs(torch.as_tensor(users), torch.as_tensor(items)),
               ours.score_candidates(torch.as_tensor(users), torch.as_tensor(cand)),
               ours.score_all(torch.as_tensor(users)))
    want = (ref.score_pairs(params, users, items), ref.score_candidates(params, users, cand),
            ref.score_all(params, users))
    for what, g, w in zip(("pairs", "candidates", "all"), got, want):
        assert g.shape == w.shape
        _close(g, w, what)
    for (g_tab, w_tab) in zip(ours.user_item_embeddings(), ref.user_item_embeddings(params)):
        _close(g_tab, w_tab)


def _port_grads(ours, batch, generator):
    ours.zero_grad(set_to_none=True)
    loss = ours.loss({k: torch.as_tensor(v) for k, v in batch.items()}, generator)
    loss.backward()
    return loss, {name: p.grad for name, p in ours.named_parameters()}


def _check_loss_and_grads(data, ref, params, ours, rng_key, generator):
    batch = _batch(data)
    want_loss, want_grads = jax.value_and_grad(ref.loss)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                                         rng_key)
    loss, grads = _port_grads(ours, batch, generator)
    _close(loss, want_loss, "loss")
    want_grads = flatten_params(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(grads) == set(want_grads)
    for name, grad in grads.items():
        _close(grad, want_grads[name], name)


@pytest.mark.parametrize("fmt", ["dense", "chunked"])
@pytest.mark.parametrize("key", list(CONFIGS))
def test_loss_and_gradients_without_dropout_match_jax(data, key, fmt):
    """No rng on the JAX side and no generator on the port's: no dropout."""
    ref, params, ours = _models(data, key, fmt)
    _check_loss_and_grads(data, ref, params, ours, None, None)


@pytest.mark.parametrize("fmt", ["dense", "chunked"])
@pytest.mark.parametrize("key", ["LightGCN-3", "LightGCN-2"])
def test_lightgcn_with_the_same_dropped_edges_matches_jax(data, key, fmt, monkeypatch):
    """Both sides propagate every layer of the step through one set of
    dropped edge values, given explicitly in place of each side's draw."""
    ref, params, ours = _models(data, key, fmt)
    vals = ours.prop.vals.numpy()
    mask = np.random.default_rng(5).uniform(size=vals.shape) < ref.keep_prob
    dropped = np.where(mask, vals / ref.keep_prob, 0.0).astype(np.float32)
    calls = []
    monkeypatch.setattr(jax_lightgcn, "edge_dropout", lambda rng, v, keep: jnp.asarray(dropped))
    monkeypatch.setattr(lightgcn, "edge_dropout", lambda gen, v, keep: calls.append(keep) or torch.as_tensor(dropped))
    _check_loss_and_grads(data, ref, params, ours, jax.random.key(0), torch.Generator())
    assert calls == [ref.keep_prob]  # one draw a step, shared by every layer


@pytest.mark.parametrize("fmt", ["dense", "chunked"])
@pytest.mark.parametrize("key", ["NGCF-3", "NGCF-2"])
def test_ngcf_with_the_same_message_masks_matches_jax(data, key, fmt, monkeypatch):
    """Both sides drop each layer's messages by the same explicit keep
    masks, given in place of each side's draw, in layer order."""
    ref, params, ours = _models(data, key, fmt)
    n_nodes = data.n_users + data.n_items
    rng = np.random.default_rng(6)
    rates = ref.mess_dropout
    masks = [rng.uniform(size=(n_nodes, width)) >= rate for rate, width in zip(rates, ref.layer_dims[1:])]
    jax_masks, port_masks = iter(masks), iter(masks)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(next(jax_masks)))

    def given_mask(generator, x, rate):
        return torch.where(torch.as_tensor(next(port_masks)), x / (1 - rate), 0.0)

    monkeypatch.setattr(ngcf, "inverted_dropout", given_mask)
    _check_loss_and_grads(data, ref, params, ours, jax.random.key(0), torch.Generator())
    assert next(jax_masks, None) is None and next(port_masks, None) is None


def test_lightgcn_edge_dropout_in_distribution(data, monkeypatch):
    """A training loss draws one edge dropout (kept share ~ keep_pro, the
    kept scaled by 1 / keep_pro); scoring draws none."""
    _, _, ours = _models(data, "LightGCN-3")
    drawn = []
    real = lightgcn.edge_dropout
    monkeypatch.setattr(lightgcn, "edge_dropout", lambda gen, v, keep: drawn.append((v, real(gen, v, keep))) or
                        drawn[-1][1])
    batch = {k: torch.as_tensor(v) for k, v in _batch(data).items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        ours.loss(batch, gen)
    with torch.no_grad():
        ours.score_all(torch.arange(data.n_users))
        ours.loss(batch)
    assert len(drawn) == 20
    vals = torch.cat([v for v, _ in drawn])
    out = torch.cat([o for _, o in drawn])
    kept = out != 0
    n, keep = vals.numel(), ours.keep_prob
    assert abs(int(kept.sum()) - keep * n) < 5 * np.sqrt(n * keep * (1 - keep))
    torch.testing.assert_close(out[kept], vals[kept] / keep, rtol=0, atol=0)


def test_ngcf_message_dropout_in_distribution(data, monkeypatch):
    """Each layer of a training loss drops its messages at its own rate
    (kept share ~ 1 - rate), the kept scaled by 1 / (1 - rate); scoring
    drops none."""
    _, _, ours = _models(data, "NGCF-2")
    seen = []

    def spy(generator, x, rate):
        out = attention.inverted_dropout(generator, x, rate)
        seen.append((generator is not None, rate, x.detach(), out.detach()))
        return out

    monkeypatch.setattr(ngcf, "inverted_dropout", spy)
    batch = {k: torch.as_tensor(v) for k, v in _batch(data).items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(10):
        ours.loss(batch, gen)
    with torch.no_grad():
        ours.score_all(torch.arange(data.n_users))
    trained = [s for s in seen if s[0]]
    assert len(trained) == 10 * ours.n_layers and all(not s[0] and torch.equal(s[2], s[3]) for s in seen[-2:])
    for layer, rate in enumerate(ours.mess_dropout):
        x = torch.cat([s[2] for s in trained[layer::ours.n_layers]])
        out = torch.cat([s[3] for s in trained[layer::ours.n_layers]])
        assert all(s[1] == rate for s in trained[layer::ours.n_layers])
        kept = out != 0
        n, keep = x.numel(), 1 - rate
        assert abs(int(kept.sum()) - keep * n) < 5 * np.sqrt(n * keep * (1 - keep))
        torch.testing.assert_close(out[kept], x[kept] / keep, rtol=0, atol=0)


def test_registry_holds_the_jax_names(data):
    adj = {"adj": data.get_norm_adj("sym")}
    for name, cls in (("LightGCN", lightgcn.LightGCN), ("lightgcn", lightgcn.LightGCN), ("NGCF", ngcf.NGCF),
                      ("ngcf", ngcf.NGCF)):
        assert MODELS[name] is cls
        assert isinstance(build_model({"model": name}, data.n_users, data.n_items, adj, device="cpu"), cls)
    with pytest.raises(ValueError, match="artifacts\\['adj'\\]"):
        build_model({"model": "LightGCN"}, data.n_users, data.n_items, device="cpu")


def test_init_draws_xavier_uniform_as_jax(data):
    """Tables and weights inside the Xavier limit with its variance
    (limit^2 / 3), biases zero; one seed draws one model."""
    _, _, ours = _models(data, "NGCF-3")
    ours.init_weights(torch.Generator().manual_seed(3))
    state = ours.state_dict()
    for name, value in state.items():
        if name.endswith(".b"):
            assert not value.any(), name
            continue
        limit = np.sqrt(6.0 / sum(value.shape))
        assert value.abs().max() <= limit and abs(float(value.var()) - limit**2 / 3) < 0.25 * limit**2 / 3, name
    again = build_model(ours.config, data.n_users, data.n_items, ours.artifacts, device="cpu")
    again.init_weights(torch.Generator().manual_seed(3))
    for name, value in again.state_dict().items():
        assert torch.equal(value, state[name]), name


class _Tables(RecModel):
    """A factorized model that counts its table computations."""

    def __init__(self):
        super().__init__({"emb_dim": 4}, 5, 6, device="cpu")
        gen = torch.Generator().manual_seed(0)
        self.u, self.i = torch.randn(5, 4, generator=gen), torch.randn(6, 4, generator=gen)
        self.calls = 0

    def user_item_embeddings(self):
        self.calls += 1
        return self.u, self.i


def test_factorized_scoring_defaults_and_holding_embeddings():
    model = _Tables()
    users = torch.tensor([0, 3, 4])
    torch.testing.assert_close(model.score_all(users), model.u[users] @ model.i.T, rtol=0, atol=0)
    torch.testing.assert_close(model.score_pairs(users, torch.tensor([1, 5, 0])),
                               (model.u[users] * model.i[[1, 5, 0]]).sum(-1), rtol=0, atol=0)
    torch.testing.assert_close(model.score_candidates(users, torch.tensor([[1, 2]] * 3)),
                               model.u[users] @ model.i[[1, 2]].T, rtol=1e-6, atol=1e-6)
    assert model.calls == 3
    with model.holding_embeddings():
        for block in (users[:1], users[1:]):
            model.score_all(block)
        model.score_pairs(users, users)
    assert model.calls == 4
    model.score_all(users)
    assert model.calls == 5
    with pytest.raises(NotImplementedError):
        RecModel({}, 2, 2, device="cpu").score_pairs(users, users)
