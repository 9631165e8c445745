"""UltraGCN and MixGCF in the port against the JAX models on the same
parameters: UltraGCN's host prep (``create_constraint_mat``,
``get_ii_constraint_mat`` on a split with tied weights), scores, losses and
every parameter's gradient against ``jax.grad`` (MixGCF at each pool, with
``ns`` "rns" and "mixgcf", with dropout off and with the same explicit
dropped edges, message masks and mixing seeds on both sides, dense and
sparse routes), the draws in distribution, the initializers against JAX's,
and the registry's names."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
from test_torch_train_mf import structured_split

import beta_recsys_tpu.models.mixgcf as jax_mixgcf
from beta_recsys_tpu.data.base_data import BaseData as JaxBaseData
from beta_recsys_tpu.models.mixgcf import MixGCF as JaxMixGCF
from beta_recsys_tpu.models.ultragcn import UltraGCN as JaxUltraGCN
from beta_recsys_tpu.ops.ultragcn_prep import get_ii_constraint_mat as jax_get_ii_constraint_mat
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.models import MODELS, build_model, mixgcf, ultragcn
from beta_recsys_tpu_torch.ops import attention
from beta_recsys_tpu_torch.ops.ultragcn_prep import get_ii_constraint_mat
from beta_recsys_tpu_torch.recommenders import UltraGCN as UltraGCNRecommender

# float32 products and propagations summed in other orders on the two sides.
RTOL, ATOL = 1e-5, 1e-6
ULTRA = {"model": "UltraGCN", "emb_dim": 16, "w1": 1e-7, "w2": 1.0, "w3": 1e-7, "w4": 1.0, "negative_weight": 50,
         "gamma": 1e-4, "lambda": 1e-3, "ii_neighbor_num": 5, "stddev": 0.1}
MIX = {"model": "MixGCF", "emb_dim": 8, "context_hops": 3, "l2": 1e-2, "n_negs": 4, "K": 2,
       "edge_dropout_rate": 0.1, "mess_dropout_rate": 0.2}


@pytest.fixture(scope="module")
def split():
    return structured_split()


@pytest.fixture(scope="module")
def data(split):
    return BaseData(split)


def _jax_data(split):
    train, valid, test = split
    return JaxBaseData((pd.DataFrame(train), [pd.DataFrame(f) for f in valid], [pd.DataFrame(f) for f in test]))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def ultragcn_artifacts(data, k=ULTRA["ii_neighbor_num"]):
    return UltraGCNRecommender({"model": dict(ULTRA, ii_neighbor_num=k)}, device="cpu").build_artifacts(data)


def _models(data, cfg, seed=0, fmt="dense"):
    """(JAX model, its params, the port's model on the same params)."""
    if cfg["model"] == "UltraGCN":
        artifacts, cls = ultragcn_artifacts(data), JaxUltraGCN
    else:
        cfg = dict(cfg, graph_format=fmt)
        artifacts, cls = {"adj": data.get_norm_adj("sym")}, JaxMixGCF
    ref = cls(cfg, data.n_users, data.n_items, artifacts)
    params = ref.init_params(jax.random.key(seed))
    ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    return ref, params, ours


def _batch(data, num_neg, seed=0, size=48):
    rng = np.random.default_rng(seed)
    return {"users": rng.integers(0, data.n_users, size), "pos_items": rng.integers(0, data.n_items, size),
            "neg_items": rng.integers(0, data.n_items, (size, num_neg))}


def _check_loss_and_grads(ref, params, ours, batch, rng_key, generator):
    want_loss, want_grads = jax.value_and_grad(ref.loss)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                                         rng_key)
    ours.zero_grad(set_to_none=True)
    loss = ours.loss({k: torch.as_tensor(v) for k, v in batch.items()}, generator)
    loss.backward()
    _close(loss, want_loss, "loss")
    want_grads = flatten_params(jax.tree_util.tree_map(np.asarray, want_grads))
    grads = {name: p.grad for name, p in ours.named_parameters()}
    assert set(grads) == set(want_grads)
    for name, grad in grads.items():
        _close(grad, want_grads[name], name)


# -- UltraGCN's host prep ---------------------------------------------------------


def test_create_constraint_mat_matches_jax(split, data):
    train_mat, beta_ud, beta_id = data.create_constraint_mat()
    want_mat, want_ud, want_id = _jax_data(split).create_constraint_mat()
    assert (train_mat != want_mat).nnz == 0 and train_mat.dtype == want_mat.dtype
    for got, want in ((beta_ud, want_ud), (beta_id, want_id)):
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


def _tied_matrix():
    """Users with identical rows: their items' co-occurrence weights tie."""
    rows = [0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4, 4, 4, 5]
    cols = [0, 1, 2, 0, 1, 2, 3, 4, 3, 4, 5, 6, 7, 8, 9]
    return sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(6, 11))


@pytest.mark.parametrize("k", [1, 3, 5, 11, 20])
@pytest.mark.parametrize("block", [2048, 4])
@pytest.mark.parametrize("diagonal_zero", [False, True])
def test_ii_constraint_mat_matches_jax_with_ties(k, block, diagonal_zero):
    mat = _tied_matrix()
    got = get_ii_constraint_mat(mat, k, ii_diagonal_zero=diagonal_zero, block=block)
    want = jax_get_ii_constraint_mat(mat, k, ii_diagonal_zero=diagonal_zero, block=block)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_ii_constraint_mat_matches_jax_on_the_split(data):
    train_mat, _, _ = data.create_constraint_mat()
    nb, sims = get_ii_constraint_mat(train_mat, 10)
    want_nb, want_sims = jax_get_ii_constraint_mat(train_mat, 10)
    assert np.array_equal(nb, want_nb) and np.array_equal(sims, want_sims)
    assert len(np.unique(sims)) < sims.size  # the split has ties


# -- UltraGCN -------------------------------------------------------------------


def test_ultragcn_scores_match_jax(data):
    ref, params, ours = _models(data, ULTRA)
    rng = np.random.default_rng(1)
    users, items = rng.integers(0, data.n_users, 30), rng.integers(0, data.n_items, 30)
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


@pytest.mark.parametrize("weights", [{}, {"w2": 0.0, "w4": 0.0}, {"w2": 0.0}])
def test_ultragcn_loss_and_gradients_match_jax(data, weights):
    ref, params, ours = _models(data, dict(ULTRA, **weights))
    _check_loss_and_grads(ref, params, ours, _batch(data, 6), jax.random.key(0), None)


def test_ultragcn_init_in_distribution_as_jax(data):
    ref, params, ours = _models(data, dict(ULTRA, stddev=1e-3, emb_dim=64))
    ours.init_weights(torch.Generator().manual_seed(0))
    for name in ("user_emb", "item_emb"):
        got, want = getattr(ours, name).detach().numpy(), np.asarray(params[name])
        n = got.size
        assert abs(got.std() - want.std()) < 5 * 1e-3 / np.sqrt(2 * n) * 2, name
        assert abs(got.mean()) < 5 * 1e-3 / np.sqrt(n), name


# -- MixGCF ---------------------------------------------------------------------


@pytest.mark.parametrize("pool", ["mean", "sum", "concat", "final"])
def test_mixgcf_scores_match_jax(data, pool):
    ref, params, ours = _models(data, dict(MIX, pool=pool))
    rng = np.random.default_rng(1)
    users, items = rng.integers(0, data.n_users, 30), rng.integers(0, data.n_items, 30)
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


def inject_mixgcf_draws(monkeypatch, ref, ours, n_nodes, batch_size, seed=5):
    """Give both sides the same dropped edge values and message masks each
    hop and the same mixing seeds, in draw order, in place of each side's
    own draws. Returns a function that says whether every draw was used."""
    rng = np.random.default_rng(seed)
    vals = ours.prop.vals.numpy()
    hops = ref.n_hops
    keep_e, rate_m = 1 - ref.edge_dropout_rate, ref.mess_dropout_rate
    edges = [np.where(rng.uniform(size=vals.shape) < keep_e, vals / keep_e, 0.0).astype(np.float32)
             for _ in range(hops)]
    masks = [rng.uniform(size=(n_nodes, ref.emb_dim)) >= rate_m for _ in range(hops)]
    seeds = [rng.uniform(size=(batch_size, 1, hops + 1, 1)).astype(np.float32) for _ in range(ref.K)]
    jax_edges, jax_masks, jax_seeds = iter(edges), iter(masks), iter(seeds)
    port_edges, port_masks, port_seeds = iter(edges), iter(masks), iter(seeds)
    monkeypatch.setattr(jax_mixgcf, "edge_dropout", lambda key, v, keep: jnp.asarray(next(jax_edges)))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(next(jax_masks)))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(next(jax_seeds)))
    monkeypatch.setattr(mixgcf, "edge_dropout", lambda gen, v, keep: torch.as_tensor(next(port_edges)))
    monkeypatch.setattr(mixgcf, "inverted_dropout",
                        lambda gen, x, rate: torch.where(torch.as_tensor(next(port_masks)), x / (1 - rate), 0.0))
    monkeypatch.setattr(mixgcf, "mixing_seeds", lambda gen, shape, device: torch.as_tensor(next(port_seeds)))

    def all_used(ns):
        left = [next(it, None) for it in (jax_edges, jax_masks, port_edges, port_masks)]
        if ns == "mixgcf":
            left += [next(jax_seeds, None), next(port_seeds, None)]
        return all(x is None for x in left)

    return all_used


@pytest.mark.parametrize("fmt", ["dense", "chunked"])
@pytest.mark.parametrize("ns", ["mixgcf", "rns"])
@pytest.mark.parametrize("pool", ["mean", "sum", "concat", "final"])
def test_mixgcf_with_the_same_draws_matches_jax(data, pool, ns, fmt, monkeypatch):
    ref, params, ours = _models(data, dict(MIX, pool=pool, ns=ns), fmt=fmt)
    batch = _batch(data, ref.num_neg)
    all_used = inject_mixgcf_draws(monkeypatch, ref, ours, data.n_users + data.n_items, 48)
    _check_loss_and_grads(ref, params, ours, batch, jax.random.key(0), torch.Generator())
    assert all_used(ns)


@pytest.mark.parametrize("pool", ["mean", "concat"])
def test_mixgcf_without_dropout_matches_jax(data, pool, monkeypatch):
    """No dropout on either side; the mixing seeds given."""
    cfg = dict(MIX, pool=pool, edge_dropout_rate=0.0, mess_dropout_rate=0.0)
    ref, params, ours = _models(data, cfg)
    seeds = np.random.default_rng(2).uniform(size=(48, 1, ref.n_hops + 1, 1)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(seeds))
    monkeypatch.setattr(mixgcf, "mixing_seeds", lambda gen, shape, device: torch.as_tensor(seeds))
    _check_loss_and_grads(ref, params, ours, _batch(data, ref.num_neg), jax.random.key(0), None)


def test_mixgcf_draws_in_distribution(data, monkeypatch):
    """Each hop of a training loss drops edges (kept share ~ 1 - rate, the
    kept scaled) and then messages, redrawn every hop; the mixing seeds are
    U[0, 1), one per (row, hop) and group; scoring draws nothing."""
    _, _, ours = _models(data, MIX)
    edges, messages, seeds = [], [], []
    real_edge, real_seeds = mixgcf.edge_dropout, mixgcf.mixing_seeds

    def edge_spy(gen, v, keep):
        edges.append((v, real_edge(gen, v, keep)))
        return edges[-1][1]

    def message_spy(gen, x, rate):
        out = attention.inverted_dropout(gen, x, rate)
        messages.append((gen is not None, x.detach(), out.detach()))
        return out

    monkeypatch.setattr(mixgcf, "edge_dropout", edge_spy)
    monkeypatch.setattr(mixgcf, "inverted_dropout", message_spy)
    monkeypatch.setattr(mixgcf, "mixing_seeds", lambda gen, shape, dev: seeds.append(real_seeds(gen, shape, dev))
                        or seeds[-1])
    batch = {k: torch.as_tensor(v) for k, v in _batch(data, ours.num_neg).items()}
    gen = torch.Generator().manual_seed(0)
    steps = 10
    for _ in range(steps):
        ours.loss(batch, gen)
    with torch.no_grad():
        ours.score_all(torch.arange(data.n_users))
    assert len(edges) == steps * ours.n_hops and len(seeds) == steps * ours.K
    assert not any(edges[i][1].equal(edges[i + 1][1]) for i in range(len(edges) - 1))
    for rate, kept_of in ((ours.edge_dropout_rate, [(v, o) for v, o in edges]),
                          (ours.mess_dropout_rate, [(x, o) for g, x, o in messages if g])):
        x = torch.cat([a.reshape(-1) for a, _ in kept_of])
        out = torch.cat([o.reshape(-1) for _, o in kept_of])
        kept = out != 0
        n, keep = x.numel(), 1 - rate
        assert abs(int(kept.sum()) - keep * n) < 5 * np.sqrt(n * keep * (1 - keep))
        torch.testing.assert_close(out[kept], x[kept] / keep, rtol=0, atol=0)
    assert [g for g, _, _ in messages].count(True) == steps * ours.n_hops
    assert all(torch.equal(x, o) for g, x, o in messages if not g)
    s = torch.cat([t.reshape(-1) for t in seeds])
    assert seeds[0].shape == (48, 1, ours.n_hops + 1, 1) and 0 <= s.min() and s.max() < 1
    assert abs(float(s.mean()) - 0.5) < 5 * np.sqrt(1 / 12 / s.numel())


def test_mixgcf_init_and_num_neg_as_jax(data):
    ref, params, ours = _models(data, dict(MIX, emb_dim=64))
    assert ours.num_neg == ref.num_neg == MIX["K"] * MIX["n_negs"]
    ours.init_weights(torch.Generator().manual_seed(0))
    for name in ("user_emb", "item_emb"):
        got, want = getattr(ours, name).detach().numpy(), np.asarray(params[name])
        limit = np.sqrt(6.0 / sum(got.shape))
        assert np.abs(got).max() <= limit and np.abs(want).max() <= limit
        assert abs(got.var() - limit**2 / 3) < 5 * limit**2 / 3 / np.sqrt(got.size / 2), name


def test_registry_holds_the_jax_names(data):
    art = {"adj": data.get_norm_adj("sym"), **ultragcn_artifacts(data)}
    for name, cls in (("UltraGCN", ultragcn.UltraGCN), ("ultragcn", ultragcn.UltraGCN),
                      ("MixGCF", mixgcf.MixGCF), ("mixgcf", mixgcf.MixGCF)):
        assert MODELS[name] is cls
        model = build_model({"model": name}, data.n_users, data.n_items, art, device="cpu")
        assert isinstance(model, cls) and model.batch_kind == "multineg"
    with pytest.raises(ValueError, match="artifacts\\['constraint'\\]"):
        build_model({"model": "UltraGCN"}, data.n_users, data.n_items, device="cpu")
    with pytest.raises(ValueError, match="artifacts\\['adj'\\]"):
        build_model({"model": "MixGCF"}, data.n_users, data.n_items, device="cpu")
