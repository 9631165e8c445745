"""The sequence (SASRec), sequence_time (TiSASRec), prefix (NARM), userrow
(VAECF) and triple (Triple2vec) trainers on a device mesh against the JAX
package: one epoch on the rows, orders and draws the JAX epoch function forms,
on (4, 1) and (2, 2) meshes, against the JAX epoch function on the same mesh
shape (dropout 0; VAECF's latent noise handed over, each data shard's own
draw from the step's key on a data axis): the loss, every parameter and
Adam's moments. On (4, 1) SASRec's loss is each shard's mean over its own
non-pad positions, then their mean, as the JAX ``shard_map`` computes it."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from test_torch_mesh_dense import MESHES, epoch_matches, every_table, jax_mesh, port_mesh
from test_torch_train_sasrec import sequence_split
from test_torch_train_seq import MODEL_CFG as SEQ_CFG
from test_torch_train_seq import _jax_order
from test_torch_train_triple import MODEL_CFG as TRIPLE_CFG

from beta_recsys_tpu.core.train_engine import _padded_order as jax_padded_order
from beta_recsys_tpu.core.train_engine import make_negative_sampler as jax_make_negative_sampler
from beta_recsys_tpu.core.train_engine import make_prefix_epoch_fn as jax_make_prefix_epoch_fn
from beta_recsys_tpu.core.train_engine import make_sequence_epoch_fn as jax_make_sequence_epoch_fn
from beta_recsys_tpu.core.train_engine import make_sequence_time_epoch_fn as jax_make_sequence_time_epoch_fn
from beta_recsys_tpu.core.train_engine import make_triple_epoch_fn as jax_make_triple_epoch_fn
from beta_recsys_tpu.core.train_engine import make_userrow_epoch_fn as jax_make_userrow_epoch_fn
from beta_recsys_tpu.data.grocery_data import GroceryData as JaxGroceryData
from beta_recsys_tpu.data.sequential_data import SequentialData as JaxSequentialData
from beta_recsys_tpu.datasets.synthetic import add_synthetic_baskets as jax_add_synthetic_baskets
from beta_recsys_tpu.models import MODEL_REGISTRY as JAX_MODELS
from beta_recsys_tpu_torch.convert import flatten_params
from beta_recsys_tpu_torch.core.train_engine import (
    PrefixEpochTrainer,
    SequenceEpochTrainer,
    SequenceTimeEpochTrainer,
    TripleEpochTrainer,
    UserRowEpochTrainer,
    make_negative_sampler,
    make_optimizer,
)
from beta_recsys_tpu_torch.data.grocery_data import GroceryData
from beta_recsys_tpu_torch.data.sequential_data import SequentialData
from beta_recsys_tpu_torch.datasets.synthetic import add_synthetic_baskets
from beta_recsys_tpu_torch.models import build_model
from beta_recsys_tpu_torch.models import vaecf as port_vaecf
from beta_recsys_tpu_torch.parallel.data_parallel import mesh_round_batch

MAXLEN, SPAN = 10, 32
SASREC = {"model": "SASRec", "emb_dim": 16, "num_blocks": 2, "num_heads": 2, "maxlen": MAXLEN, "dropout_rate": 0.0,
          "l2_emb": 0.1}


@pytest.fixture(scope="module")
def both():
    split = sequence_split()
    train, valid, test = split
    return SequentialData(split), JaxSequentialData(
        (pd.DataFrame(train), [pd.DataFrame(f) for f in valid], [pd.DataFrame(f) for f in test]))


def _models(cfg, data, artifacts=None, seed=0):
    cfg = {**cfg, "lr": 1e-3, "optimizer": "adam"}
    ref = JAX_MODELS[cfg["model"]](cfg, data.n_users, data.n_items, artifacts)
    params = ref.init_params(jax.random.key(seed))
    ours = build_model(cfg, data.n_users, data.n_items, artifacts, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    return cfg, ref, params, ours


def _run(ref, params, jax_epoch, rng, trainer, ours, batches, **kwargs):
    opt = optax.adam(1e-3)
    want_params, want_state, _, want_loss = jax_epoch(ref, opt)(params, opt.init(params), rng)
    assert trainer.num_batches == batches[0].shape[0] == int(want_state[0].count)
    loss = trainer.run_batches(*batches, **kwargs)
    epoch_matches(trainer, ours, loss, want_params, want_state, want_loss)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", ["SASRec", "TiSASRec"])
def test_sequence_epoch_on_a_mesh_matches_jax(both, every_table, name, mesh_shape):
    """Rows drawn with replacement, batch 10 (8 on a data axis of 4; the
    users' sequences are ragged)."""
    data, jax_data = both
    cfg, ref, params, ours = _models(SASREC if name == "SASRec" else SEQ_CFG["TiSASRec"], data)
    mesh = port_mesh(mesh_shape)
    batch_size = mesh_round_batch(10, mesh)
    assert batch_size == (8 if mesh_shape[0] == 4 else 10)
    neg_sampler = jax_make_negative_sampler(jax_data)
    if name == "SASRec":
        arrays, jax_arrays = data.train_seq_arrays(MAXLEN), jax_data.train_seq_arrays(MAXLEN)
        jax_fn, cls = jax_make_sequence_epoch_fn, SequenceEpochTrainer
    else:
        arrays, jax_arrays = data.tisasrec_arrays(MAXLEN, SPAN), jax_data.tisasrec_arrays(MAXLEN, SPAN)
        jax_fn, cls = jax_make_sequence_time_epoch_fn, SequenceTimeEpochTrainer
    rng = jax.random.key(4)
    n = len(jax_arrays["users"])
    _, k_row, k_neg, _ = jax.random.split(rng, 4)
    rows = jax.random.randint(k_row, (n // batch_size, batch_size), 0, n)
    users = jnp.asarray(jax_arrays["users"])[rows]
    neg0 = neg_sampler(k_neg, users[..., None], (n // batch_size, batch_size, MAXLEN))
    trainer = cls(ours, make_optimizer(cfg, ours.parameters()), arrays, 10, make_negative_sampler(data, device="cpu"),
                  mesh=mesh)
    assert trainer.batch_size == batch_size and not trainer.dp.tables  # the (n_items + 1)-row table stays whole
    _run(ref, params, lambda r, o: jax_fn(r, o, jax_arrays, 10, neg_sampler, donate=False,
                                          mesh=jax_mesh(mesh_shape)),
         rng, trainer, ours, tuple(np.array(x) for x in (rows, users, neg0)))


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_prefix_epoch_on_a_mesh_matches_jax(both, every_table, mesh_shape):
    """NARM on the wrapped permutation, batch 62 (60 on a data axis of 4)."""
    data, jax_data = both
    cfg, ref, params, ours = _models(SEQ_CFG["NARM"], data)
    mesh = port_mesh(mesh_shape)
    arrays = jax_data.prefix_target_arrays(MAXLEN)
    rng = jax.random.key(5)
    order, _ = _jax_order(rng, len(arrays["target"]), mesh_round_batch(62, mesh))
    trainer = PrefixEpochTrainer(ours, make_optimizer(cfg, ours.parameters()), data.prefix_target_arrays(MAXLEN), 62,
                                 mesh=mesh)
    assert (trainer.num_batches, trainer.batch_size) == order.shape
    _run(ref, params, lambda r, o: jax_make_prefix_epoch_fn(r, o, arrays, 62, donate=False,
                                                            mesh=jax_mesh(mesh_shape)),
         rng, trainer, ours, (order,))


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_userrow_epoch_on_a_mesh_matches_jax(both, monkeypatch, every_table, mesh_shape):
    """VAECF, batch 14 (12 on a data axis of 4): on a data axis each shard
    draws its own rows' latent noise from the step's key, so each shard's
    noise is JAX's normal(key, (B / N, z)); on (2, 2) the whole batch's."""
    data, jax_data = both
    cfg, ref, params, ours = _models(SEQ_CFG["VAECF"], data)
    mesh = port_mesh(mesh_shape)
    n_data = mesh_shape[0] if mesh_shape[1] == 1 else 1
    rows = (np.asarray(jax_data.user_item_csr().todense()) > 0).astype(np.float32)
    rng = jax.random.key(6)
    batch_size = mesh_round_batch(14, mesh)
    order, keys = _jax_order(rng, data.n_users, batch_size)
    noise = [np.array(jax.random.normal(k, (batch_size // n_data, cfg["z_dim"]))) for k in keys for _ in range(n_data)]
    monkeypatch.setattr(port_vaecf, "latent_noise", lambda generator, shape, device: torch.from_numpy(noise.pop(0)))
    trainer = UserRowEpochTrainer(ours, make_optimizer(cfg, ours.parameters()), rows, 14, mesh=mesh,
                                  )
    assert (trainer.num_batches, trainer.batch_size) == order.shape
    _run(ref, params, lambda r, o: jax_make_userrow_epoch_fn(r, o, rows, 14, donate=False, mesh=jax_mesh(mesh_shape)),
         rng, trainer, ours, (order,), generator=torch.Generator().manual_seed(0))
    assert not noise


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_triple_epoch_on_a_mesh_matches_jax(every_table, mesh_shape):
    """Triple2vec on the JAX order and uniform negatives, batch 62 (60 on a
    data axis of 4); the tied item_emb2 keeps optax's zero moments."""
    train, valid, test = sequence_split()
    data = GroceryData((add_synthetic_baskets(train, 3), valid, test))
    jax_data = JaxGroceryData((jax_add_synthetic_baskets(pd.DataFrame(train), 3), [pd.DataFrame(f) for f in valid],
                               [pd.DataFrame(f) for f in test]))
    cfg, ref, params, ours = _models(TRIPLE_CFG["Triple2vec"], data, seed=1)
    mesh = port_mesh(mesh_shape)
    batch_size, n_neg = mesh_round_batch(62, mesh), cfg["n_neg"]
    triples = data.sample_triples(cfg["n_sample"], seed=4)
    assert all(np.array_equal(triples[k], v) for k, v in jax_data.sample_triples(cfg["n_sample"], seed=4).items())
    n = len(triples["users"])
    num_batches = -(-n // batch_size)
    rng = jax.random.key(7)
    _, perm_key, k1, k2, k3, _ = jax.random.split(rng, 6)
    order = jax_padded_order(jax.random.permutation(perm_key, n), num_batches * batch_size)
    shape = (num_batches, batch_size, n_neg)
    negatives = [jax.random.randint(k, shape, 0, size, dtype=jnp.int32)
                 for k, size in ((k1, data.n_users), (k2, data.n_items), (k3, data.n_items))]
    trainer = TripleEpochTrainer(ours, make_optimizer(cfg, ours.parameters()), triples, 62, data.n_users,
                                 data.n_items, n_neg, mesh=mesh)
    assert trainer.batch_size == batch_size
    _run(ref, params, lambda r, o: jax_make_triple_epoch_fn(r, o, triples, 62, data.n_users, data.n_items, n_neg,
                                                            donate=False, mesh=jax_mesh(mesh_shape)),
         rng, trainer, ours, tuple(np.array(x) for x in (order.reshape(num_batches, batch_size), *negatives)),
         generator=torch.Generator().manual_seed(0))
