"""GMF, MLP and NeuMF in the port against the JAX package, on the same
parameters (carried across by convert.py) and the same numpy inputs:
scores, BCE losses and the gradients of every parameter (with the same
dropout masks on both sides where the tower drops), the warm start, the
initialisers, the registry, and the evaluator on a model without
``item_emb``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beta_recsys_tpu.models.mlp as jax_mlp_module
import beta_recsys_tpu.models.ncf as jax_ncf_module
from beta_recsys_tpu.core.eval_engine import RankingEvaluator as JaxRankingEvaluator
from beta_recsys_tpu.data.base_data import EvalCandidates as JaxEvalCandidates
from beta_recsys_tpu.models import losses as jax_losses
from beta_recsys_tpu.models import MODEL_REGISTRY
from beta_recsys_tpu.models.gmf import GMF as JaxGMF
from beta_recsys_tpu.models.mlp import MLP as JaxMLP
from beta_recsys_tpu.models.ncf import NeuMF as JaxNeuMF
from beta_recsys_tpu_torch.convert import (
    gmf_params_from_jax,
    mlp_params_from_jax,
    ncf_params_from_jax,
    nest_dotted,
    params_to_jax,
)
from beta_recsys_tpu_torch.core.eval_engine import RankingEvaluator
from beta_recsys_tpu_torch.data.base_data import EvalCandidates
from beta_recsys_tpu_torch.models import MODELS, build_model, losses
from beta_recsys_tpu_torch.models.gmf import GMF
from beta_recsys_tpu_torch.models.mlp import MLP
from beta_recsys_tpu_torch.models.ncf import NeuMF
from beta_recsys_tpu_torch.ops import attention as port_attention

N_USERS, N_ITEMS, D, B = 37, 53, 8, 11
SCORE_RTOL, SCORE_ATOL = 1e-6, 1e-7
# The JAX lookups' one-hot-matmul backward sums a row's gradients in
# another order than the port's indexing backward.
GRAD_ATOL = 1e-6

FAMILY = {
    "GMF": (JaxGMF, GMF, gmf_params_from_jax),
    "MLP": (JaxMLP, MLP, mlp_params_from_jax),
    "NCF": (JaxNeuMF, NeuMF, ncf_params_from_jax),
}


def _config(name, n_layers=3, dropout=0.0):
    return {"model": name, "emb_dim": D, "mlp_config": {"n_layers": n_layers}, "dropout": dropout,
            "stddev": 0.3, "num_negative": 4}


def _randomize(params, seed):
    """Non-zero biases, so every term of the towers is held."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']") or name.endswith("['affine_b']"):
            return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(fill, params)


def _pair(name, seed=0, **cfg):
    """The JAX model, its params (numpy) and the port's model on them."""
    jax_cls, port_cls, convert = FAMILY[name]
    config = _config(name, **cfg)
    ref = jax_cls(config, N_USERS, N_ITEMS)
    params = _randomize(ref.init_params(jax.random.key(seed)), seed)
    ours = port_cls(config, N_USERS, N_ITEMS, device="cpu")
    ours.load_state_dict(convert(params))
    return ref, params, ours


def _batch(seed=1, n=B):
    rng = np.random.default_rng(seed)
    return {"users": rng.integers(0, N_USERS, n).astype(np.int32),
            "items": rng.integers(0, N_ITEMS, n).astype(np.int32),
            "labels": (rng.random(n) < 0.3).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v.astype(np.int64))
            for k, v in batch.items()}


def _scores_close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=SCORE_RTOL, atol=SCORE_ATOL,
                               err_msg=what)


def _grads_close(ours, want_grads, convert):
    want = convert(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(want) == {name for name, _ in ours.named_parameters()}
    for name, p in ours.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("name", list(FAMILY))
def test_scores_match_jax(name):
    ref, params, ours = _pair(name)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    b = _batch()
    users, items = b["users"], b["items"]
    cands = np.random.default_rng(2).integers(0, N_ITEMS, (B, 7)).astype(np.int32)
    t = {k: torch.from_numpy(v.astype(np.int64)) for k, v in (("u", users), ("i", items), ("c", cands))}
    with torch.no_grad():
        _scores_close(ours.score_pairs(t["u"], t["i"]),
                      ref.score_pairs(jparams, jnp.asarray(users), jnp.asarray(items)))
        _scores_close(ours.score_candidates(t["u"], t["c"]),
                      ref.score_candidates(jparams, jnp.asarray(users), jnp.asarray(cands)))
        _scores_close(ours.score_all(t["u"]), ref.score_all(jparams, jnp.asarray(users)))


@pytest.mark.parametrize("name,n_layers", [("GMF", 3), ("MLP", 2), ("MLP", 3), ("NCF", 2), ("NCF", 3)])
def test_loss_and_gradients_match_jax(name, n_layers):
    ref, params, ours = _pair(name, n_layers=n_layers)
    b = _batch(n=40)
    want_loss, want_grads = jax.value_and_grad(ref.loss)(
        jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in b.items()}, None)
    loss = ours.loss(_torch_batch(b))
    loss.backward()
    _scores_close(loss, want_loss)
    _grads_close(ours, want_grads, FAMILY[name][2])
    assert ours.batch_kind == ref.batch_kind == "pointwise"


@pytest.mark.parametrize("name", ["MLP", "NCF"])
def test_loss_and_gradients_match_jax_with_the_same_dropout_masks(name, monkeypatch):
    """Both towers are handed the same masks, one before each Linear, in
    order; without a generator (the port) or a key (JAX) nothing drops."""
    rate, n = 0.3, 40
    ref, params, ours = _pair(name, dropout=rate)
    widths = [D * 2 ** (3 - i) for i in range(3)]
    rng = np.random.default_rng(5)
    masks = [rng.random((n, w)) >= rate for w in widths]
    jax_calls, port_calls = [], []

    def jax_dropout(key, x, r):
        keep = masks[len(jax_calls)]
        jax_calls.append(x.shape)
        return jnp.where(keep, x / (1 - r), 0.0)

    def port_mask(generator, shape, r, device):
        port_calls.append(tuple(shape))
        return torch.from_numpy(masks[len(port_calls) - 1])

    module = jax_mlp_module if name == "MLP" else jax_ncf_module
    monkeypatch.setattr(module, "inverted_dropout", jax_dropout)
    monkeypatch.setattr(port_attention, "dropout_mask", port_mask)
    b = _batch(n=n)
    want_loss, want_grads = jax.value_and_grad(ref.loss)(
        jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(3))
    loss = ours.loss(_torch_batch(b), torch.Generator().manual_seed(0))
    loss.backward()
    assert jax_calls == port_calls == [(n, w) for w in widths]
    _scores_close(loss, want_loss)
    _grads_close(ours, want_grads, FAMILY[name][2])
    port_calls.clear()
    with torch.no_grad():
        plain = ours.loss(_torch_batch(b))
    assert not port_calls
    _scores_close(plain, ref.loss(jax.tree_util.tree_map(jnp.asarray, params),
                                  {k: jnp.asarray(v) for k, v in b.items()}, None))


def test_bce_loss_matches_jax_including_the_clip():
    rng = np.random.default_rng(4)
    probs = np.concatenate([rng.random(40), [0.0, 1.0, 1e-9, 1 - 1e-9, 1e-7, 1 - 1e-7]]).astype(np.float32)
    labels = (rng.random(len(probs)) < 0.5).astype(np.float32)
    labels[-6:] = [1, 0, 1, 0, 1, 0]  # the clipped ends, each at its worst label
    got = losses.bce_loss(torch.from_numpy(probs), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_losses.bce_loss(probs, labels)), rtol=1e-6)
    # Wrong with certainty: each term is clipped to -log(1e-7) (1 - 1e-7 rounds
    # to 1 - 2^-23 in float32, so the second lands at ~15.94).
    ends = np.array([0.0, 1.0], np.float32), np.array([1.0, 0.0], np.float32)
    at_ends = losses.bce_loss(*(torch.from_numpy(a) for a in ends))
    assert torch.isfinite(at_ends) and 15.9 < float(at_ends) < 16.2
    np.testing.assert_allclose(at_ends.numpy(), np.asarray(jax_losses.bce_loss(*ends)), rtol=1e-6)


@pytest.mark.parametrize("name", list(FAMILY))
def test_init_draws_the_reference_distributions_and_converts_both_ways(name):
    """normal(0, stddev) tables, LeCun-normal (truncated at 2 std) weights,
    zero biases; ``params_to_jax`` gives the JAX ``init_params`` tree (lists
    keyed "0", "1", ... as a checkpoint stores them) and converts back."""
    config = {**_config(name), "emb_dim": 32, "stddev": 0.01}
    ours = build_model(config, 400, 500, device="cpu").init_weights(torch.Generator().manual_seed(0))
    state = ours.state_dict()
    for table in [k for k in state if "emb" in k]:
        assert abs(float(state[table].std()) - 0.01) < 1e-3, table
    for key, value in state.items():
        leaf = key.rsplit(".", 1)[-1].removeprefix("affine_")
        if leaf == "b":
            assert not value.any(), key
        elif leaf == "w":
            fan_in = value.shape[0]
            assert float(value.abs().max()) <= 2 * np.sqrt(1 / fan_in) / 0.87962566103423978 + 1e-6, key
    big = torch.empty(4096, 64)
    from beta_recsys_tpu_torch.models.mlp import lecun_normal_

    lecun_normal_(big, torch.Generator().manual_seed(1))
    assert abs(float(big.std()) - np.sqrt(1 / 4096)) < 2e-4

    tree = params_to_jax(state)
    want = FAMILY[name][0](config, 400, 500).init_params(jax.random.key(0))
    flat_want = FAMILY[name][2](jax.tree_util.tree_map(np.asarray, want))
    flat_got = FAMILY[name][2](tree)
    assert {k: v.shape for k, v in flat_got.items()} == {k: v.shape for k, v in flat_want.items()}
    back = build_model(config, 400, 500, device="cpu")
    back.load_state_dict(FAMILY[name][2](tree))
    for key, value in back.state_dict().items():
        assert torch.equal(value, state[key]), key


def test_registry_holds_the_jax_names():
    for key, cls in (("GMF", GMF), ("MLP", MLP), ("NCF", NeuMF), ("NeuMF", NeuMF), ("ncf", NeuMF)):
        assert MODELS[key] is cls
        assert isinstance(build_model(_config(key), 5, 6, device="cpu"), cls)
    # Every name of the JAX registry is ported; another name raises.
    assert set(MODEL_REGISTRY) <= set(MODELS)
    with pytest.raises(ValueError, match="Unknown model"):
        build_model({"model": "NoSuchModel"}, 5, 6, device="cpu")


def _pretrained(seed):
    """GMF and MLP params trees from the JAX initialisers."""
    gmf = _randomize(JaxGMF(_config("GMF"), N_USERS, N_ITEMS).init_params(jax.random.key(seed)), seed)
    mlp = _randomize(JaxMLP(_config("MLP"), N_USERS, N_ITEMS).init_params(jax.random.key(seed + 1)), seed + 1)
    return gmf, mlp


@pytest.mark.parametrize("layout", ["jax_list", "checkpoint_dict", "port_state"])
def test_warm_start_takes_the_pretrained_tables_and_layers_bit_for_bit(layout):
    gmf, mlp = _pretrained(3)
    if layout == "checkpoint_dict":
        gmf, mlp = params_to_jax(gmf_params_from_jax(gmf)), params_to_jax(mlp_params_from_jax(mlp))
        assert set(mlp["layers"]) == {"0", "1", "2"}
    elif layout == "port_state":
        gmf = nest_dotted(GMF(_config("GMF"), N_USERS, N_ITEMS, device="cpu").init_weights(
            torch.Generator().manual_seed(1)).state_dict())
        mlp = nest_dotted(MLP(_config("MLP"), N_USERS, N_ITEMS, device="cpu").init_weights(
            torch.Generator().manual_seed(2)).state_dict())
    artifacts = {"gmf_params": gmf, "mlp_params": mlp}
    ours = NeuMF(_config("NCF"), N_USERS, N_ITEMS, artifacts=artifacts, device="cpu")
    ours.init_weights(torch.Generator().manual_seed(0))
    state = ours.state_dict()
    g, m = gmf_params_from_jax(gmf), mlp_params_from_jax(mlp)
    for side in ("user", "item"):
        assert torch.equal(state[f"{side}_emb_gmf"], g[f"{side}_emb"])
        assert torch.equal(state[f"{side}_emb_mlp"], m[f"{side}_emb"])
    for i in range(3):
        for leaf in ("w", "b"):
            assert torch.equal(state[f"layers.{i}.{leaf}"], m[f"layers.{i}.{leaf}"])
    if layout == "jax_list":
        # The JAX warm start puts the same values in the same places.
        want = ncf_params_from_jax(jax.tree_util.tree_map(
            np.asarray, JaxNeuMF(_config("NCF"), N_USERS, N_ITEMS, artifacts=artifacts).init_params(jax.random.key(0))))
        for key in state:
            if key.startswith("affine"):
                continue  # drawn by each package's own generator
            assert torch.equal(state[key], want[key]), key


def test_warm_start_of_one_tower_keeps_the_other_drawn():
    gmf, _ = _pretrained(4)
    cold = NeuMF(_config("NCF"), N_USERS, N_ITEMS, device="cpu").init_weights(torch.Generator().manual_seed(0))
    warm = NeuMF(_config("NCF"), N_USERS, N_ITEMS, artifacts={"gmf_params": gmf}, device="cpu")
    warm.init_weights(torch.Generator().manual_seed(0))
    for key, value in cold.state_dict().items():
        if "gmf" in key:
            assert torch.equal(warm.state_dict()[key], gmf_params_from_jax(gmf)[key.replace("_gmf", "")])
        else:
            assert torch.equal(warm.state_dict()[key], value), key


@pytest.mark.parametrize("tower,cfg", [("gmf_params", {"emb_dim": 2 * D}), ("mlp_params", {"emb_dim": 2 * D}),
                                        ("mlp_params", {"mlp_config": {"n_layers": 4}})])
def test_warm_start_of_another_width_or_depth_raises(tower, cfg):
    """A GMF or MLP pretrained at another emb_dim or depth than NeuMF's does
    not fit its towers: the warm start says so instead of copying."""
    model = {"gmf_params": "GMF", "mlp_params": "MLP"}[tower]
    tree = FAMILY[model][0]({**_config(model), **cfg}, N_USERS, N_ITEMS).init_params(jax.random.key(0))
    ours = NeuMF(_config("NCF"), N_USERS, N_ITEMS, artifacts={tower: tree}, device="cpu")
    with pytest.raises(ValueError, match=f"{tower}.*pretrain with NeuMF's emb_dim"):
        ours.init_weights(torch.Generator().manual_seed(0))


def test_evaluator_scores_a_model_without_item_emb():
    """The evaluator takes its device from the model, not from a table that
    NeuMF does not have, and gives the JAX evaluator's metrics."""
    ref, params, ours = _pair("NCF")
    assert not hasattr(ours, "item_emb")
    rng = np.random.default_rng(6)
    users = np.arange(20, dtype=np.int32)
    items = rng.integers(0, N_ITEMS, (20, 12)).astype(np.int32)
    relevance = np.zeros((20, 12), np.float32)
    relevance[:, 0] = 1.0
    mask = np.ones((20, 12), bool)
    mask[::3, -2:] = False
    cands = EvalCandidates(users, items, relevance, relevance.copy(), mask)
    got = RankingEvaluator(ours, cands, ("ndcg", "recall"), (5, 10)).evaluate()
    want = JaxRankingEvaluator(ref, JaxEvalCandidates(users, items, relevance, relevance.copy(), mask),
                               ("ndcg", "recall"), (5, 10)).evaluate(jax.tree_util.tree_map(jnp.asarray, params))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)
