"""TiSASRec, NARM and VAECF in the port against the JAX package at a small
size: scores, losses and gradients from the same converted parameters, with
the same dropout masks (TiSASRec, NARM) or the same latent noise (VAECF)
handed to both sides; TiSASRec's bucketed time terms against a direct (B, T,
T, D) form; the initializers' trees and distributions; the registry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beta_recsys_tpu.models.narm as jax_narm_module
import beta_recsys_tpu.models.tisasrec as jax_tisasrec_module
import beta_recsys_tpu.ops.attention as jax_attention
from beta_recsys_tpu.models.narm import NARM as JaxNARM
from beta_recsys_tpu.models.tisasrec import TiSASRec as JaxTiSASRec
from beta_recsys_tpu.models.vaecf import VAECF as JaxVAECF
from beta_recsys_tpu_torch.convert import flatten_params, params_to_jax
from beta_recsys_tpu_torch.models import MODELS, build_model
from beta_recsys_tpu_torch.models import tisasrec as port_tisasrec
from beta_recsys_tpu_torch.models import vaecf as port_vaecf
from beta_recsys_tpu_torch.models.narm import NARM
from beta_recsys_tpu_torch.models.tisasrec import TiSASRec
from beta_recsys_tpu_torch.models.vaecf import VAECF
from beta_recsys_tpu_torch.ops import attention as port_attention

TOL = 1e-5  # float32 through the blocks, the GRU and their gradients, summed in other orders
N_USERS, N_ITEMS, MAXLEN, D, SPAN, B = 12, 30, 8, 16, 16, 6


def _randomize(params, seed, scale=0.3):
    """Every leaf drawn anew (non-zero biases, GRU and LN terms), so each
    term of the model is held; row 0 of an item table stays the pad row."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        value = (scale * rng.standard_normal(leaf.shape)).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['item_emb']"):
            value[0] = 0.0
        return value

    return jax.tree_util.tree_map_with_path(fill, params)


def _contexts(seed=2):
    """Left-padded 1-indexed contexts (one user with no items) and interval
    matrices that reach past SPAN (the model clips them)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, MAXLEN + 1, N_USERS)
    lengths[0], lengths[1] = 0, MAXLEN
    ctx = np.zeros((N_USERS, MAXLEN), np.int32)
    for u, n in enumerate(lengths):
        ctx[u, MAXLEN - n:] = rng.integers(1, N_ITEMS + 1, n)
    tm = rng.integers(0, SPAN + 5, (N_USERS, MAXLEN, MAXLEN)).astype(np.int32)
    return ctx, np.minimum(tm, tm.transpose(0, 2, 1))


def _pair(jax_cls, port_cls, cfg, artifacts, seed=0):
    ref = jax_cls(cfg, N_USERS, N_ITEMS, artifacts={k: np.asarray(v) for k, v in artifacts.items()})
    params = _randomize(ref.init_params(jax.random.key(seed)), seed)
    ours = port_cls(cfg, N_USERS, N_ITEMS, artifacts=artifacts, device="cpu")
    ours.load_state_dict(flatten_params(params))
    return ref, jax.tree_util.tree_map(jnp.asarray, params), ours


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _grads_close(ours, want_grads):
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(want) == {name for name, _ in ours.named_parameters()}
    for name, p in ours.named_parameters():
        _close(p.grad, want[name], what=name)


def _users_and_candidates(seed=4, n_cand=7):
    rng = np.random.default_rng(seed)
    users = np.arange(N_USERS)
    cand = rng.integers(0, N_ITEMS, (N_USERS, n_cand)).astype(np.int32)
    return users, cand


def _check_scores(ref, params, ours):
    users, cand = _users_and_candidates()
    tu, tc = torch.as_tensor(users), torch.as_tensor(cand, dtype=torch.long)
    with torch.no_grad():
        got_cand = ours.score_candidates(tu, tc)
        got_all = ours.score_all(tu)
        got_pairs = ours.score_pairs(tu.repeat_interleave(3), tc[:, :3].reshape(-1))
    want_cand = ref.score_candidates(params, jnp.asarray(users), jnp.asarray(cand))
    _close(got_cand, want_cand, what="score_candidates")
    _close(got_all, ref.score_all(params, jnp.asarray(users)), what="score_all")
    # The JAX models have no pair score: a pair scores as its candidate does.
    _close(got_pairs, np.asarray(want_cand)[:, :3].reshape(-1), what="score_pairs")


# -- TiSASRec ------------------------------------------------------------------


def _tisasrec_cfg(**cfg):
    return {"model": "TiSASRec", "emb_dim": D, "num_blocks": 2, "num_heads": 2, "maxlen": MAXLEN,
            "time_span": SPAN, "dropout_rate": 0.0, "l2_emb": 0.05, **cfg}


def _tisasrec(**cfg):
    ctx, tm = _contexts()
    return _pair(JaxTiSASRec, TiSASRec, _tisasrec_cfg(**cfg), {"ctx": ctx, "ctx_time": tm})


def _tisasrec_batch(seed=1, t=MAXLEN):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, N_ITEMS + 1, (B, t)).astype(np.int32)
    seq[:, : t // 3] = 0
    seq[0] = 0  # a row of padding alone
    pos = np.where(seq != 0, rng.integers(1, N_ITEMS + 1, seq.shape), 0).astype(np.int32)
    neg = np.where(pos != 0, rng.integers(1, N_ITEMS + 1, seq.shape), 0).astype(np.int32)
    tm = rng.integers(0, SPAN + 5, (B, t, t)).astype(np.int32)
    return {"seq": seq, "pos": pos, "neg": neg, "time_matrix": tm}


def _torch_batch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long if v.dtype.kind in "iu" else torch.float32)
            for k, v in batch.items()}


def test_tisasrec_scores_match_jax():
    _check_scores(*_tisasrec())


@pytest.mark.parametrize("t", [MAXLEN, 5], ids=["T=maxlen", "T<maxlen"])
def test_tisasrec_loss_and_gradients_match_jax(t):
    ref, params, ours = _tisasrec()
    batch = _tisasrec_batch(t=t)
    want_loss, want_grads = jax.value_and_grad(ref.loss)(params, jax.tree_util.tree_map(jnp.asarray, batch),
                                                         jax.random.key(3))
    loss = ours.loss(_torch_batch(batch), torch.Generator().manual_seed(0))
    loss.backward()
    _close(loss, want_loss)
    _grads_close(ours, want_grads)


def test_tisasrec_loss_and_gradients_match_jax_with_the_same_dropout_masks(monkeypatch):
    """Both packages are handed the same masks in the same order: the
    embedding, then per block FFN 1 and FFN 2; the attention has none."""
    rate = 0.3
    ref, params, ours = _tisasrec(dropout_rate=rate)
    batch = _tisasrec_batch()
    rng = np.random.default_rng(7)
    shapes = [(B, MAXLEN, D)] * 5
    masks = [rng.random(shape) >= rate for shape in shapes]
    jax_calls, port_calls = [], []

    def jax_dropout(key, x, r):
        keep = masks[len(jax_calls)]
        jax_calls.append(x.shape)
        return jnp.where(keep, x / (1 - r), 0.0)

    def port_mask(generator, shape, r, device):
        port_calls.append(tuple(shape))
        return torch.from_numpy(masks[len(port_calls) - 1])

    monkeypatch.setattr(jax_attention, "_dropout", jax_dropout)
    monkeypatch.setattr(jax_tisasrec_module, "inverted_dropout", jax_dropout)
    monkeypatch.setattr(port_attention, "dropout_mask", port_mask)
    want_loss, want_grads = jax.value_and_grad(ref.loss)(params, jax.tree_util.tree_map(jnp.asarray, batch),
                                                         jax.random.key(3))
    loss = ours.loss(_torch_batch(batch), torch.Generator().manual_seed(0))
    loss.backward()
    assert jax_calls == port_calls == shapes
    _close(loss, want_loss)
    _grads_close(ours, want_grads)


def _direct_time_aware_mha(blk, q, k, tm, time_k, time_v, pos_k, pos_v, n_heads):
    """The JAX package's form: (B, T, T, D) gathers of the time tables."""
    B, T, D = q.shape
    dh = D // n_heads

    def heads(x):
        return x.reshape(*x.shape[:-1], n_heads, dh)

    Q, K, V = heads(q @ blk["wq"]), heads(k @ blk["wk"]), heads(k @ blk["wv"])
    tK, tV, pK, pV = heads(time_k[tm]), heads(time_v[tm]), heads(pos_k), heads(pos_v)
    logits = (torch.einsum("bqhd,bkhd->bhqk", Q, K) + torch.einsum("bqhd,khd->bhqk", Q, pK)
              + torch.einsum("bqkhd,bqhd->bhqk", tK, Q)) / dh ** 0.5
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    probs = torch.softmax(torch.where(causal, logits, port_tisasrec.NEG_INF), dim=-1)
    out = (torch.einsum("bhqk,bkhd->bqhd", probs, V) + torch.einsum("bhqk,khd->bqhd", probs, pV)
           + torch.einsum("bhqk,bqkhd->bqhd", probs, tV))
    return out.reshape(B, T, D) @ blk["wo"]


@pytest.mark.parametrize("n_heads", [1, 2, 4])
def test_tisasrec_bucketed_time_terms_equal_the_direct_gathers(n_heads):
    """The per-head (B, h, T, S) score and bucket form against the (B, T, T,
    D) gathers, forward and every input's gradient, at skewed intervals (a
    third of them at the clip, as the structured split has a sixth)."""
    rng = np.random.default_rng(n_heads)
    _, _, ours = _tisasrec(num_heads=n_heads)
    blk = ours.blocks[0]["attn"]
    q, k = (torch.tensor(rng.standard_normal((B, MAXLEN, D)), dtype=torch.float32, requires_grad=True)
            for _ in range(2))
    tm = torch.as_tensor(np.where(rng.random((B, MAXLEN, MAXLEN)) < 0.33, SPAN,
                                  rng.integers(0, SPAN + 1, (B, MAXLEN, MAXLEN))))
    pos_k, pos_v = ours.abs_pos_k, ours.abs_pos_v
    inputs = [q, k, ours.time_k, ours.time_v, pos_k, pos_v, *blk.values()]
    flat = port_tisasrec.bucket_flat_index(tm, n_heads, SPAN + 1)
    got = port_tisasrec.time_aware_mha(blk, q, k, flat, ours.time_k, ours.time_v, pos_k, pos_v, n_heads)
    want = _direct_time_aware_mha(blk, q, k, tm, ours.time_k, ours.time_v, pos_k, pos_v, n_heads)
    _close(got, want.detach())
    probe = torch.tensor(rng.standard_normal(got.shape), dtype=torch.float32)
    got_grads = torch.autograd.grad((got * probe).sum(), inputs)
    want_grads = torch.autograd.grad((want * probe).sum(), inputs)
    for i, (g, w) in enumerate(zip(got_grads, want_grads)):
        _close(g, w, what=f"input {i}")


# -- NARM ------------------------------------------------------------------------


def _narm_cfg(**cfg):
    return {"model": "NARM", "emb_dim": 10, "hidden_size": 14, "maxlen": MAXLEN, "dropout_input": 0.0,
            "dropout_hidden": 0.0, **cfg}


def _narm(**cfg):
    return _pair(JaxNARM, NARM, _narm_cfg(**cfg), {"ctx": _contexts()[0]})


def _narm_batch(seed=1, n=9):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, MAXLEN + 1, n)
    seq = np.zeros((n, MAXLEN), np.int32)
    for i, m in enumerate(lengths):
        seq[i, MAXLEN - m:] = rng.integers(1, N_ITEMS + 1, m)
    return {"seq": seq, "target": rng.integers(1, N_ITEMS + 1, n).astype(np.int32)}


def test_narm_scores_match_jax_with_a_trained_bn_over_padding():
    """Every parameter non-zero (``bn`` too): a left-padded row's hidden
    state holds through its pads only if the cell keeps JAX's form."""
    ref, params, ours = _narm()
    assert float(jnp.abs(params["gru"]["bn"]).min()) > 0
    _check_scores(ref, params, ours)


def test_narm_loss_and_gradients_match_jax():
    ref, params, ours = _narm()
    batch = _narm_batch()
    want_loss, want_grads = jax.value_and_grad(ref.loss)(params, jax.tree_util.tree_map(jnp.asarray, batch),
                                                         jax.random.key(3))
    loss = ours.loss(_torch_batch(batch), torch.Generator().manual_seed(0))
    loss.backward()
    _close(loss, want_loss)
    _grads_close(ours, want_grads)


def test_narm_loss_and_gradients_match_jax_with_the_same_dropout_masks(monkeypatch):
    """The input dropout, then the hidden one, the same masks on both sides;
    without a generator (the port) or a key (JAX) nothing drops."""
    ref, params, ours = _narm(dropout_input=0.25, dropout_hidden=0.5)
    batch = _narm_batch()
    n = batch["seq"].shape[0]
    rng = np.random.default_rng(8)
    shapes = [(n, MAXLEN, 10), (n, 28)]
    masks = [rng.random(shape) >= rate for shape, rate in zip(shapes, (0.25, 0.5))]
    jax_calls, port_calls = [], []

    def jax_dropout(key, x, r):
        keep = masks[len(jax_calls)]
        jax_calls.append(x.shape)
        return jnp.where(keep, x / (1 - r), 0.0)

    def port_mask(generator, shape, r, device):
        port_calls.append(tuple(shape))
        return torch.from_numpy(masks[len(port_calls) - 1])

    monkeypatch.setattr(jax_narm_module, "inverted_dropout", jax_dropout)
    monkeypatch.setattr(port_attention, "dropout_mask", port_mask)
    want_loss, want_grads = jax.value_and_grad(ref.loss)(params, jax.tree_util.tree_map(jnp.asarray, batch),
                                                         jax.random.key(3))
    loss = ours.loss(_torch_batch(batch), torch.Generator().manual_seed(0))
    loss.backward()
    assert jax_calls == port_calls == shapes
    _close(loss, want_loss)
    _grads_close(ours, want_grads)
    port_calls.clear()
    with torch.no_grad():
        plain = ours.loss(_torch_batch(batch))
    assert not port_calls
    _close(plain, ref.loss(params, jax.tree_util.tree_map(jnp.asarray, batch), None))


# -- VAECF -----------------------------------------------------------------------


def _user_rows(seed=3):
    rng = np.random.default_rng(seed)
    rows = (rng.random((N_USERS, N_ITEMS)) < 0.2).astype(np.float32)
    rows[0] = 0.0  # a user with no train item
    return rows


def _vaecf(**cfg):
    cfg = {"model": "VAECF", "z_dim": 4, "ae_structure": [12, 8], "activation": "tanh", "likelihood": "mult",
           "beta": 0.7, **cfg}
    return _pair(JaxVAECF, VAECF, cfg, {"user_rows": _user_rows()})


@pytest.mark.parametrize("activation", ["sigmoid", "tanh", "relu", "relu6"])
def test_vaecf_scores_match_jax(activation):
    _check_scores(*_vaecf(activation=activation))


@pytest.mark.parametrize("likelihood,activation", [("mult", "tanh"), ("bern", "sigmoid"), ("gaus", "relu"),
                                                   ("pois", "relu6")])
def test_vaecf_loss_and_gradients_match_jax_with_the_same_noise(likelihood, activation, monkeypatch):
    """The port's latent noise is the JAX loss's own draw from its key."""
    ref, params, ours = _vaecf(likelihood=likelihood, activation=activation)
    users = np.array([0, 3, 5, 7, 11])
    batch = {"rows": _user_rows()[users], "users": users.astype(np.int32)}
    key = jax.random.key(5)
    eps = np.array(jax.random.normal(key, (len(users), 4)))
    draws = []

    def noise(generator, shape, device):
        draws.append(tuple(shape))
        return torch.from_numpy(eps)

    monkeypatch.setattr(port_vaecf, "latent_noise", noise)
    want_loss, want_grads = jax.value_and_grad(ref.loss)(params, jax.tree_util.tree_map(jnp.asarray, batch), key)
    loss = ours.loss(_torch_batch(batch), torch.Generator().manual_seed(0))
    loss.backward()
    assert draws == [(len(users), 4)]
    _close(loss, want_loss)
    _grads_close(ours, want_grads)


def test_vaecf_loss_needs_a_generator_and_draws_standard_normal_noise():
    _, _, ours = _vaecf()
    batch = _torch_batch({"rows": _user_rows(), "users": np.arange(N_USERS, dtype=np.int32)})
    with pytest.raises(ValueError, match="generator"):
        ours.loss(batch)
    gen = torch.Generator().manual_seed(0)
    assert not torch.equal(ours.loss(batch, gen), ours.loss(batch, gen))
    eps = port_vaecf.latent_noise(torch.Generator().manual_seed(1), (20000, 4), "cpu")
    assert abs(float(eps.mean())) < 0.03 and abs(float(eps.std()) - 1) < 0.03


# -- all three -------------------------------------------------------------------

INITS = {
    "TiSASRec": (JaxTiSASRec, TiSASRec, _tisasrec_cfg(maxlen=50, time_span=256, emb_dim=64)),
    "NARM": (JaxNARM, NARM, _narm_cfg(emb_dim=50, hidden_size=100)),
    "VAECF": (JaxVAECF, VAECF, {"model": "VAECF", "z_dim": 10, "ae_structure": [20]}),
}


@pytest.mark.parametrize("name", list(INITS))
def test_init_draws_the_jax_tree_and_distributions(name):
    """The port's initializer gives the JAX tree (names, shapes), the pad
    row at 0 and, leaf by leaf, the JAX initializer's mean and spread; the
    tree converts both ways bit for bit."""
    jax_cls, port_cls, cfg = INITS[name]
    n_items = 400
    want = flatten_params(jax_cls(cfg, N_USERS, n_items).init_params(jax.random.key(0)))
    ours = port_cls(cfg, N_USERS, n_items, device="cpu").init_weights(torch.Generator().manual_seed(0))
    state = ours.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in want.items()}
    for key, value in state.items():
        ref = want[key]
        if key == "item_emb":
            assert torch.all(value[0] == 0) and torch.all(ref[0] == 0)
            value, ref = value[1:], ref[1:]
        if ref.numel() < 100 or float(ref.std()) == 0:
            assert torch.equal(value, ref), key  # zero biases, unit LN scales
            continue
        assert abs(float(value.mean() - ref.mean())) < 0.1 * float(ref.std()) + 1e-3, key
        assert abs(float(value.std() / ref.std()) - 1) < 0.1, key
    back = port_cls(cfg, N_USERS, n_items, device="cpu")
    back.load_state_dict(flatten_params(params_to_jax(state)))
    for key, value in back.state_dict().items():
        assert torch.equal(value, state[key]), key


def test_registry_holds_the_jax_sequence_and_vae_names():
    for key, cls in (("TiSASRec", TiSASRec), ("tisasrec", TiSASRec), ("NARM", NARM), ("narm", NARM),
                     ("VAECF", VAECF), ("vaecf", VAECF)):
        assert MODELS[key] is cls
        assert cls.batch_kind == {"TiSASRec": "sequence_time", "NARM": "prefix", "VAECF": "userrow"}[cls.__name__]
        assert isinstance(build_model({"model": key}, 5, 6, device="cpu"), cls)
