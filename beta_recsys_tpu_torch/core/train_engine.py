"""Training engine: epoch trainers, early stop and checkpoints.

Counterpart of ``beta_recsys_tpu/core/train_engine.py`` on one device for the
pairwise (BPR), multineg (``num_neg`` negatives a positive), pointwise (BCE),
sequence (SASRec), sequence_time (TiSASRec), prefix (NARM), userrow (VAECF),
triple (Triple2vec, VBCAR, TVBR) and none (UserKNN, ItemKNN: nothing to
train) batch kinds: ``make_optimizer`` (optax's sgd, adam and rmsprop),
``make_negative_sampler``, ``_padded_order``, the dense pairwise, multineg
and pointwise trainers (``make_epoch_fn``), the sequence trainers
(``SequenceEpochTrainer`` and ``SequenceTimeEpochTrainer``, the
counterparts of ``make_sequence_epoch_fn`` and
``make_sequence_time_epoch_fn``), the permutation trainers
(``PrefixEpochTrainer``, ``UserRowEpochTrainer`` and
``TripleEpochTrainer``, of ``make_prefix_epoch_fn``,
``make_userrow_epoch_fn`` and ``make_triple_epoch_fn``) and ``TrainEngine``
(``build``, ``train``, ``save_checkpoint``, ``resume_checkpoint``,
``resume_training``, ``test``). Models
with a row protocol and ``"sparse_optim": true`` train through the
lazy-Adam trainer of ``core/sparse_optim.py``; with ``system.mesh`` through
its row-sharded counterpart on a device mesh (``ShardedSparseEpochTrainer``),
routed as the JAX package routes it. Every other trainer takes the mesh
through its ``DataParallelStep`` (``parallel/data_parallel.py``): data
shards on a pure data axis, row-sharded tables on a model axis, batch
sizes rounded down to a multiple of the data axis.

As in the JAX package, an epoch's batches are formed once before its step
loop (the row draw or permutation, and the negatives), drawn on the device
from one ``torch.Generator`` seeded from ``system.seed``. The step loop
consumes them through ``run_batches``, which also takes batches formed
elsewhere; a step draws its dropout or latent noise from the same
generator. Losses stay on the device; the host reads the mean once per
epoch.

A checkpoint holds the parameters and the optimizer state in the JAX
package's layout, so either package resumes the other's ``last/``. ``rng``
holds threefry-shaped key data (two uint32), which the JAX engine wraps as
its key; the port's own generator state goes beside it as ``torch_rng``
(the JAX package ignores the extra key), so a resumed port run repeats an
uninterrupted one bit for bit. A checkpoint without ``torch_rng`` (the JAX
package's) cannot continue its threefry stream in PyTorch: the generator is
seeded with the key data read as one 64-bit number, ``k0 * 2**32 + k1``.
"""

import hashlib
import os
import random
import string
import time
from contextlib import contextmanager
from datetime import datetime

import numpy as np
import torch

from ..convert import flatten_params, nest_dotted, params_to_jax
from ..device import resolve_device
from ..parallel.data_parallel import DataParallelStep, Replicas, mesh_round_batch, pointwise_prepare
from ..ops.sampling import (
    alias_negatives,
    make_membership_test,
    sample_negatives_rejection,
    sample_negatives_rejection_bitmask,
    uniform_negatives,
)
from ..utils.alias_table import AliasTable
from ..utils.constants import DEFAULT_ITEM_COL, DEFAULT_USER_COL, MAX_N_UPDATE
from .checkpoint import check_backend, load_metadata, load_raw_checkpoint, save_checkpoint, save_metadata
from .eval_engine import EvalBookkeeper, RankingEvaluator, test_eval
from .mixed_precision import compute_dtype_of, torch_dtype

# Dense positive bitmasks are used for rejection sampling up to this many cells.
_BITMASK_CELL_LIMIT = 64 * 1024 * 1024

# Above this many bytes of row tables, "sparse_optim": "auto" on a mesh of
# several devices routes to the row-sharded sparse trainer, as the JAX package
# does: a dense data-parallel step would all-reduce the full table gradient.
AUTO_SPARSE_TABLE_BYTES = 8 * 1024 * 1024


# optax.rmsprop's defaults, which the JAX package keeps.
RMSPROP_DECAY = 0.9
RMSPROP_EPS = 1e-8


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)`` at its defaults: nu <- 0.9 * nu + 0.1 * g^2
    from nu = 0, then p <- p - lr * g / sqrt(nu + 1e-8), eps inside the
    root; no momentum, no centring, no bias correction. ``torch.optim
    .RMSprop`` is another formula (alpha 0.99, eps outside the root). A
    parameter without a gradient steps as optax steps a zero gradient. The
    state of a parameter is ``{"nu": tensor}``, optax's ``ScaleByRmsState``."""

    def __init__(self, params, lr):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params, grads, nus = [], [], []
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                if p.grad is None:  # optax's zero gradient: nu decays, p stays
                    state["nu"].mul_(RMSPROP_DECAY)
                    continue
                params.append(p)
                grads.append(p.grad)
                nus.append(state["nu"])
            if not params:
                continue
            # optax's order of operations, so the roundings are its own; one
            # launch an operation for every parameter of the group.
            torch._foreach_mul_(nus, RMSPROP_DECAY)
            squares = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(squares, 1 - RMSPROP_DECAY)
            torch._foreach_add_(nus, squares)
            steps = torch._foreach_add(nus, RMSPROP_EPS)
            torch._foreach_rsqrt_(steps)
            torch._foreach_mul_(steps, grads)
            torch._foreach_mul_(steps, -group["lr"])
            torch._foreach_add_(params, steps)
        return loss


def make_optimizer(model_cfg, params):
    """sgd, adam or rmsprop over ``params``, as optax gives them: optax's
    adam is torch's Adam with betas (0.9, 0.999) and eps 1e-8; its rmsprop
    is ``OptaxRMSprop``. As in the JAX package, a config's ``momentum`` and
    ``grad_clip`` are not read."""
    name = model_cfg.get("optimizer", "adam")
    lr = float(model_cfg.get("lr", 1e-3))
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "rmsprop":
        return OptaxRMSprop(params, lr=lr)
    raise ValueError(f"Unknown optimizer {name}")


def make_negative_sampler(data, mode="auto", device=None):
    """fn(generator, users, shape) -> negative item ids on the users' device.
    The positives live on ``device`` (the GPU when None: ``resolve_device``).

    mode: 'uniform' (no rejection), 'bitmask', 'csr', or 'auto' (bitmask for
    small catalogs, the CSR membership test otherwise)."""
    device = resolve_device(device)
    n_items = data.n_items
    if mode == "uniform":
        return lambda gen, users, shape: uniform_negatives(gen, shape, n_items, users.device)
    if mode == "auto":
        mode = "bitmask" if data.n_users * data.n_items <= _BITMASK_CELL_LIMIT else "csr"
    if mode == "bitmask":
        pos_mask = torch.as_tensor(data.pos_bitmask(), device=device)
        return lambda gen, users, shape: sample_negatives_rejection_bitmask(
            gen, users, shape, n_items, pos_mask
        )
    if mode == "csr":
        is_positive = make_membership_test(*data.pos_csr(), device=device)
        return lambda gen, users, shape: sample_negatives_rejection(
            gen, users, shape, n_items, is_positive
        )
    raise ValueError(f"Unknown negative sampler mode {mode}")


def _padded_order(perm, padded_size):
    """Extend a permutation to ``padded_size`` by wrapping."""
    n = perm.shape[0]
    if padded_size == n:
        return perm
    return perm.repeat(-(-padded_size // n))[:padded_size]


class EpochBatches:
    """An epoch's pairwise or multineg batches formed at once, then a step
    loop over them. Each positive gets negatives of shape ``neg_shape``: ()
    one (pairwise), (num_neg,) for a multineg batch, rejected against the
    positive's user. Subclasses define ``step(users, pos, neg, generator) ->
    0-d loss tensor``; each step draws its dropout, if the model has any,
    from the epoch's generator. On a ``mesh`` the batch size is rounded down
    to a multiple of its data axis (``mesh_round_batch``)."""

    def __init__(self, train_arrays, batch_size, neg_sampler, device, neg_shape=(), mesh=None):
        self.device = torch.device(device)
        self.users = torch.as_tensor(train_arrays.users, dtype=torch.long, device=self.device)
        self.items = torch.as_tensor(train_arrays.items, dtype=torch.long, device=self.device)
        self.n = self.users.shape[0]
        if self.n == 0:
            raise ValueError("empty training set for interaction batches — check filters/splits")
        self.batch_size = mesh_round_batch(min(int(batch_size), self.n), mesh)
        self.num_batches = -(-self.n // self.batch_size)
        self.padded_size = self.num_batches * self.batch_size
        self.neg_sampler = neg_sampler
        self.neg_shape = tuple(neg_shape)

    def form(self, generator):
        """(users, pos, neg): (num_batches, batch_size) and (num_batches,
        batch_size, *neg_shape), on the device."""
        perm = torch.randperm(self.n, generator=generator, device=self.device)
        order = _padded_order(perm, self.padded_size)
        users, pos = self.users[order], self.items[order]
        owners = users.view(-1, *(1,) * len(self.neg_shape))
        neg = self.neg_sampler(generator, owners, (self.padded_size, *self.neg_shape))
        shape = (self.num_batches, self.batch_size)
        return users.view(shape), pos.view(shape), neg.view(*shape, *self.neg_shape)

    def run(self, generator):
        """Form this epoch's batches and train on them; the mean batch loss."""
        return self.run_batches(*self.form(generator), generator=generator)

    def run_batches(self, users, pos, neg, generator=None):
        """Train on (num_batches, B) users and positives and (num_batches, B,
        *neg_shape) negatives; the mean batch loss as a 0-d device tensor."""
        users, pos, neg = (torch.as_tensor(x, dtype=torch.long, device=self.device) for x in (users, pos, neg))
        total = torch.zeros((), device=self.device)
        for b in range(users.shape[0]):
            total += self.step(users[b], pos[b], neg[b], generator)
        return total / users.shape[0]

    def step(self, users, pos, neg, generator):
        raise NotImplementedError


class DenseEpochTrainer(EpochBatches):
    """Every trained parameter updates through ``optimizer`` from
    ``model.loss`` on pairwise batches, or multineg ones with ``neg_shape``
    (num_neg,): the ``"pairwise"`` and ``"multineg"`` branches of the JAX
    ``make_epoch_fn``, whose batch is {"users", "pos_items", "neg_items"}
    either way. After each optimizer step the model's ``post_update()``, if
    it has one (BUIR's target EMA), moves the parameters no gradient reaches,
    as the JAX ``make_epoch_fn`` step calls it. Each step goes through a
    ``DataParallelStep`` (``self.dp``) on ``mesh`` (None: one device), whose
    tables a model axis row-shards per ``default_param_rule``;
    ``self.optimizer`` is the optimizer it steps."""

    def __init__(self, model, optimizer, train_arrays, batch_size, neg_sampler, neg_shape=(), mesh=None,
                 prepare=None, compute_dtype=None):
        super().__init__(train_arrays, batch_size, neg_sampler, next(model.parameters()).device, neg_shape, mesh)
        self.model = model
        self.dp = DataParallelStep(model, optimizer, mesh, prepare=prepare,
                                   post_update=getattr(model, "post_update", None), compute_dtype=compute_dtype)
        self.optimizer = self.dp.optimizer

    def step(self, users, pos, neg, generator):
        return self.dp({"users": users, "pos_items": pos, "neg_items": neg}, generator)


class PointwiseEpochTrainer(DenseEpochTrainer):
    """Dense trainer on pointwise (BCE) batches, the ``kind == "pointwise"``
    branch of the JAX ``make_epoch_fn``: each step trains on its B positives
    labelled with their binarized train ratings and on ``num_neg`` sampled
    negatives per positive, labelled 0, for the positive's user
    (``_pointwise_prepare``). Each step's dropout, if the model has any, is
    drawn from the epoch's generator. The table lookups' backward sorts its
    ids and sums each row's gradients in that order (no atomics), so a seed
    repeats bit for bit on the card.

    ``run(generator)`` forms the epoch's batches and trains on them;
    ``run_batches(users, items, neg, labels, generator=None)`` trains on
    given (num_batches, B) users, items and labels and (num_batches,
    B * num_neg) negatives, the negatives of each positive together. Both
    return the mean batch loss as a 0-d device tensor."""

    def __init__(self, model, optimizer, train_arrays, batch_size, neg_sampler, num_neg, mesh=None,
                 compute_dtype=None):
        super().__init__(model, optimizer, train_arrays, batch_size, neg_sampler, mesh=mesh, prepare=pointwise_prepare,
                         compute_dtype=compute_dtype)
        self.ratings = torch.as_tensor(train_arrays.ratings, dtype=torch.float32, device=self.device)
        self.num_neg = int(num_neg)

    def form(self, generator):
        """(users, items, neg, labels): (num_batches, B), (num_batches, B),
        (num_batches, B * num_neg) and (num_batches, B), on the device."""
        perm = torch.randperm(self.n, generator=generator, device=self.device)
        order = _padded_order(perm, self.padded_size)
        users, items, labels = self.users[order], self.items[order], self.ratings[order]
        u_rep = users.repeat_interleave(self.num_neg)
        neg = self.neg_sampler(generator, u_rep, (self.padded_size * self.num_neg,))
        shape = (self.num_batches, self.batch_size)
        return users.view(shape), items.view(shape), neg.view(self.num_batches, -1), labels.view(shape)

    def run(self, generator):
        return self.run_batches(*self.form(generator), generator=generator)

    def run_batches(self, users, items, neg, labels, generator=None):
        users, items, neg = (torch.as_tensor(x, dtype=torch.long, device=self.device) for x in (users, items, neg))
        labels = torch.as_tensor(labels, dtype=torch.float32, device=self.device)
        total = torch.zeros((), device=self.device)
        for b in range(users.shape[0]):
            total += self.step(users[b], items[b], neg[b], labels[b], generator)
        return total / users.shape[0]

    def step(self, users, items, neg, labels, generator):
        # The raw fields: each data shard expands its own rows
        # (``pointwise_prepare``), as the JAX grad function does.
        return self.dp({"u": users, "it": items, "neg": neg, "r": labels}, generator)


def make_epoch_fn(model, optimizer, train_arrays, batch_size, neg_sampler, num_neg=1, mesh=None,
                  compute_dtype=None):
    """The dense whole-epoch trainer for the model's pairwise, multineg or
    pointwise batches (the last two with ``num_neg`` negatives a positive),
    on ``mesh`` when given, its loss in ``compute_dtype`` when given."""
    kind = model.batch_kind
    if kind == "pairwise":
        return DenseEpochTrainer(model, optimizer, train_arrays, batch_size, neg_sampler, mesh=mesh,
                                 compute_dtype=compute_dtype)
    if kind == "multineg":
        return DenseEpochTrainer(model, optimizer, train_arrays, batch_size, neg_sampler, (int(num_neg),), mesh,
                                 compute_dtype=compute_dtype)
    if kind == "pointwise":
        return PointwiseEpochTrainer(model, optimizer, train_arrays, batch_size, neg_sampler, num_neg, mesh,
                                     compute_dtype)
    raise ValueError(f"make_epoch_fn handles pairwise/pointwise/multineg; got {kind}")


class SequenceEpochTrainer:
    """Whole-epoch trainer for sequence models (SASRec), the counterpart of
    ``make_sequence_epoch_fn``. Each epoch draws ``max(n // B, 1)`` batches
    of ``B`` training rows with replacement and one negative per position,
    rejected against the user's positives and shifted +1 into the 1-indexed
    item space (0 at padded positions). Every parameter updates through
    ``optimizer`` from ``model.loss(batch, generator)``.

    ``run(generator)`` forms the epoch's batches and trains on them, drawing
    each step's dropout from ``generator``; ``run_batches(rows, users, neg0,
    generator=None)`` trains on given (num_batches, B) rows and users and
    (num_batches, B, maxlen) 0-indexed negatives. Both return the mean batch
    loss as a 0-d device tensor. Each step goes through a ``DataParallelStep``
    on ``mesh`` (None: one device), as ``DenseEpochTrainer``'s does.
    """

    def __init__(self, model, optimizer, seq_arrays, batch_size, neg_sampler, mesh=None, compute_dtype=None):
        self.model = model
        self.dp = DataParallelStep(model, optimizer, mesh, compute_dtype=compute_dtype)
        self.optimizer = self.dp.optimizer
        self.device = next(model.parameters()).device
        self.users, self.seq, self.pos = (
            torch.as_tensor(seq_arrays[key], dtype=torch.long, device=self.device) for key in ("users", "seq", "pos")
        )
        self.n = self.users.shape[0]
        if self.n == 0:
            raise ValueError("empty training set for sequence batches (users need >= 2 interactions)")
        self.batch_size = mesh_round_batch(min(int(batch_size), self.n), mesh)
        self.num_batches = max(self.n // self.batch_size, 1)
        self.maxlen = self.seq.shape[1]
        self.neg_sampler = neg_sampler

    def form(self, generator):
        """(rows, users, neg0): (num_batches, B), (num_batches, B) and
        (num_batches, B, maxlen), on the device."""
        shape = (self.num_batches, self.batch_size)
        rows = torch.randint(0, self.n, shape, generator=generator, device=self.device)
        users = self.users[rows]
        neg0 = self.neg_sampler(generator, users[..., None], (*shape, self.maxlen))
        return rows, users, neg0

    def run(self, generator):
        """Form this epoch's batches and train on them; the mean batch loss."""
        return self.run_batches(*self.form(generator), generator=generator)

    def run_batches(self, rows, users, neg0, generator=None):
        rows, users, neg0 = (torch.as_tensor(x, dtype=torch.long, device=self.device) for x in (rows, users, neg0))
        total = torch.zeros((), device=self.device)
        for b in range(rows.shape[0]):
            total += self.step(rows[b], users[b], neg0[b], generator)
        return total / rows.shape[0]

    def batch(self, rows, users, neg0):
        pos = self.pos[rows]
        return {"users": users, "seq": self.seq[rows], "pos": pos, "neg": torch.where(pos != 0, neg0 + 1, 0)}

    def step(self, rows, users, neg0, generator):
        return self.dp(self.batch(rows, users, neg0), generator)


class SequenceTimeEpochTrainer(SequenceEpochTrainer):
    """``SequenceEpochTrainer`` whose batches also carry each row's (maxlen,
    maxlen) clipped interval matrix (``seq_arrays["time_matrix"]``, from
    ``SequentialData.tisasrec_arrays``): the counterpart of
    ``make_sequence_time_epoch_fn`` (TiSASRec)."""

    def __init__(self, model, optimizer, seq_arrays, batch_size, neg_sampler, mesh=None, compute_dtype=None):
        super().__init__(model, optimizer, seq_arrays, batch_size, neg_sampler, mesh, compute_dtype)
        self.time_matrix = torch.as_tensor(seq_arrays["time_matrix"], dtype=torch.long, device=self.device)

    def batch(self, rows, users, neg0):
        return {**super().batch(rows, users, neg0), "time_matrix": self.time_matrix[rows]}


class PermutationEpochTrainer:
    """Each epoch draws a permutation of the ``n`` examples, wraps it to
    ceil(n / B) batches of ``B`` (``_padded_order``) and takes one optimizer
    step a batch; every parameter updates through ``optimizer`` from
    ``model.loss(self.batch(order, *draws), generator)``, whose draws
    (dropout, latent noise) come from the epoch's generator.

    ``run(generator)`` forms the epoch's order (and a subclass's per-batch
    draws) and trains on it; ``run_batches(order, *draws, generator=None)``
    trains on a given (num_batches, B) order and (num_batches, B, ...)
    draws. Both return the mean batch loss as a 0-d device tensor. Each step
    goes through a ``DataParallelStep`` on ``mesh`` (None: one device)."""

    def __init__(self, model, optimizer, n, batch_size, what, mesh=None, compute_dtype=None):
        self.model = model
        self.dp = DataParallelStep(model, optimizer, mesh, compute_dtype=compute_dtype)
        self.optimizer = self.dp.optimizer
        self.device = next(model.parameters()).device
        self.n = int(n)
        if self.n == 0:
            raise ValueError(f"empty training set for {what}")
        self.batch_size = mesh_round_batch(min(int(batch_size), self.n), mesh)
        self.num_batches = -(-self.n // self.batch_size)
        self.padded_size = self.num_batches * self.batch_size

    def form(self, generator):
        """(order,): (num_batches, B) example ids, on the device."""
        perm = torch.randperm(self.n, generator=generator, device=self.device)
        return (_padded_order(perm, self.padded_size).view(self.num_batches, self.batch_size),)

    def run(self, generator):
        """Form this epoch's order and train on it; the mean batch loss."""
        return self.run_batches(*self.form(generator), generator=generator)

    def run_batches(self, order, *draws, generator=None):
        order = torch.as_tensor(order, dtype=torch.long, device=self.device)
        draws = [torch.as_tensor(d, dtype=torch.long, device=self.device) for d in draws]
        total = torch.zeros((), device=self.device)
        for b in range(order.shape[0]):
            total += self.dp(self.batch(order[b], *(d[b] for d in draws)), generator)
        return total / order.shape[0]

    def batch(self, order, *draws):
        raise NotImplementedError


class PrefixEpochTrainer(PermutationEpochTrainer):
    """(prefix, target) session examples (``SequentialData
    .prefix_target_arrays``), a batch {"seq", "target"}: the counterpart of
    ``make_prefix_epoch_fn`` (NARM)."""

    def __init__(self, model, optimizer, arrays, batch_size, mesh=None, compute_dtype=None):
        self.seq = torch.as_tensor(arrays["seq"], dtype=torch.long, device=next(model.parameters()).device)
        self.target = torch.as_tensor(arrays["target"], dtype=torch.long, device=self.seq.device)
        super().__init__(model, optimizer, self.seq.shape[0], batch_size, "prefix/target examples", mesh,
                         compute_dtype)

    def batch(self, order):
        return {"seq": self.seq[order], "target": self.target[order]}


class UserRowEpochTrainer(PermutationEpochTrainer):
    """Rows of the (n_users, n_items) binarized interaction matrix, a batch
    {"rows", "users"}: the counterpart of ``make_userrow_epoch_fn``
    (VAECF)."""

    def __init__(self, model, optimizer, user_rows, batch_size, mesh=None, compute_dtype=None):
        self.rows = torch.as_tensor(user_rows, dtype=torch.float32, device=next(model.parameters()).device)
        super().__init__(model, optimizer, self.rows.shape[0], batch_size, "user rows", mesh, compute_dtype)

    def batch(self, order):
        return {"rows": self.rows[order], "users": order}


class TripleEpochTrainer(PermutationEpochTrainer):
    """(user, item1, item2[, t]) basket triples (``GroceryData
    .sample_triples``, drawn once and kept on the device), a batch {"users",
    "item1", "item2"[, "t"], "neg_users", "neg_item1", "neg_item2"}: the
    counterpart of ``make_triple_epoch_fn`` (Triple2vec, VBCAR, TVBR). Each
    epoch draws (num_batches, B, n_neg) negatives after its permutation:
    users, then the first and the second items, each uniform or, given
    ``user_alias`` or ``item_alias`` ((prob, alias) tables on the device,
    ``alias_tables``), by Walker's alias method."""

    def __init__(self, model, optimizer, triples, batch_size, n_users, n_items, n_neg, user_alias=None,
                 item_alias=None, mesh=None, compute_dtype=None):
        device = next(model.parameters()).device
        self.triples = {key: torch.as_tensor(values, dtype=torch.long, device=device)
                        for key, values in triples.items()}
        super().__init__(model, optimizer, self.triples["users"].shape[0], batch_size, "basket triples", mesh,
                         compute_dtype)
        self.n_users, self.n_items, self.n_neg = int(n_users), int(n_items), int(n_neg)
        self.user_alias, self.item_alias = user_alias, item_alias

    def _negatives(self, generator, alias, n):
        shape = (self.num_batches, self.batch_size, self.n_neg)
        if alias is None:
            return uniform_negatives(generator, shape, n, self.device)
        return alias_negatives(generator, shape, *alias)

    def form(self, generator):
        """(order, neg_users, neg_item1, neg_item2): (num_batches, B) triple
        ids and (num_batches, B, n_neg) negatives, on the device."""
        (order,) = super().form(generator)
        return (order, self._negatives(generator, self.user_alias, self.n_users),
                self._negatives(generator, self.item_alias, self.n_items),
                self._negatives(generator, self.item_alias, self.n_items))

    def batch(self, order, neg_users, neg_item1, neg_item2):
        return {**{key: values[order] for key, values in self.triples.items()},
                "neg_users": neg_users, "neg_item1": neg_item1, "neg_item2": neg_item2}


def alias_tables(ids, size, device):
    """(prob float32, alias int64) on ``device``: the ``AliasTable`` of the
    ids' train frequencies over 0..size-1, as the JAX engine builds it for
    the triple trainer's popularity negatives."""
    table = AliasTable(list(np.bincount(np.asarray(ids), minlength=size).astype(np.float64)))
    return (torch.as_tensor(table.prob_arr, dtype=torch.float32, device=device),
            torch.as_tensor(table.alias_arr, dtype=torch.long, device=device))


def make_run_id(model_cfg):
    """``<model>_<config_id>_<timestamp>_<6 letters>``, the JAX package's run id."""
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    tag = "".join(random.SystemRandom().choices(string.ascii_lowercase, k=6))
    return f"{model_cfg.get('model', 'model')}_{model_cfg.get('config_id', 'default')}_{timestamp}_{tag}"


def final_test(config, model, candidates_list, model_run_id, result_para=None, run_time=None):
    """The final test of ``model`` over candidate copies: a
    ``RankingEvaluator`` each, the mean row appended to
    ``<root_dir>/<result_dir>/<result_file>`` and, with ``system.save_mode``
    "per_user", the first copy's candidates written to
    ``<root_dir>/<result_dir>/<model_run_id>_per_user.csv``. Returns the
    mean row."""
    sys_cfg = config.system
    metrics = tuple(sys_cfg.get("metrics", ["ndcg", "precision", "recall", "map"]))
    ks = tuple(sys_cfg.get("k", [5, 10, 20]))
    result_dir = os.path.join(sys_cfg.get("root_dir", "."), sys_cfg.get("result_dir", "results/"))
    evaluators = [RankingEvaluator(model, cand, metrics, ks) for cand in candidates_list]
    mean_row, _ = test_eval(evaluators, result_file=os.path.join(result_dir, sys_cfg.get("result_file", "result.csv")),
                            result_para=result_para or {}, run_time=run_time,
                            save_mode=sys_cfg.get("save_mode", "average"),
                            per_user_file=os.path.join(result_dir, f"{model_run_id}_per_user.csv"))
    return mean_row


def _key_data(generator_state):
    """Two uint32 of threefry-shaped key data, derived from the generator's
    state, for the checkpoint's ``rng``."""
    return np.frombuffer(hashlib.blake2b(generator_state.tobytes(), digest_size=8).digest(), dtype=np.uint32).copy()


class TrainEngine:
    """Run lifecycle: build the trainer, train with early stop, checkpoint,
    resume, test.

    ``system.mesh`` = {"data": N, "model": M} (or "auto": every device on
    "data") trains on a mesh of ``mesh_devices``: by default every CUDA device,
    ``device`` first, and too few raise. A mesh whose shards repeat a device
    exists only when ``mesh_devices`` names it so (``["cuda:0"] * 4``,
    ``["cpu"] * 4``). The per-epoch evaluators score on the mesh's data
    shards; the final ``test()`` on one device. A resumed run is placed on
    the mesh again.

    ``system.profile`` writes a ``torch.profiler`` trace (host, and the card
    where the run is on one) of epochs 0-1 to ``<root_dir>/<run_dir>/
    <model_run_id>/profile/trace.json``, the JAX trace's place.
    ``system.log_to_file`` tees stdout and stderr into the run's log files
    (``utils/logger.py``)."""

    def __init__(self, config, device, mesh_devices=None):
        self.config = config
        self.device = torch.device(device)
        self.mesh_devices = mesh_devices
        self.mesh = None
        self.sharded = False
        sys_cfg, model_cfg = config.system, config.model
        check_backend(sys_cfg.get("checkpoint_backend"))
        self.model_run_id = make_run_id(model_cfg)
        root = sys_cfg.get("root_dir", ".")
        # stdout and stderr teed into <root>/<log_dir>/<run id>.std{out,err}.log
        # for the rest of the process (``run_logger.restore()`` ends it).
        self.run_logger = None
        if sys_cfg.get("log_to_file", False):
            from ..utils.logger import Logger

            self.run_logger = Logger(os.path.join(root, sys_cfg.get("log_dir", "logs/")), self.model_run_id)
        self.checkpoint_dir = os.path.join(root, sys_cfg.get("checkpoint_dir", "checkpoints/"), self.model_run_id)
        self.profile_dir = (os.path.join(root, sys_cfg.get("run_dir", "runs/"), self.model_run_id, "profile")
                            if sys_cfg.get("profile", False) else None)
        self.seed = int(sys_cfg.get("seed", 2020))
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.epoch_seconds = []
        self.start_epoch = 0
        self.run_time = None
        # The final-epoch parameters while the model holds the best ones
        # (``hold_best``); None while the model holds its own.
        self.live_state = None

    def build(self, model, data, valid_candidates=None, test_candidates=None):
        """Initialise the model's weights and wire the epoch trainer and the
        evaluators."""
        self.model, self.data = model, data
        model_cfg, sys_cfg = self.config.model, self.config.system
        # Mixed precision: the loss in compute_dtype over float32 master
        # weights, gradients and moments (core/mixed_precision.py).
        compute_dtype = compute_dtype_of(self.config)
        torch_dtype(compute_dtype)  # an unknown name raises here
        model.init_weights(torch.Generator().manual_seed(self.seed))
        kind = model.batch_kind
        self.mesh = self._make_mesh(sys_cfg.get("mesh"))
        sparse_req = model_cfg.get("sparse_optim", "auto")
        sparse_capable = hasattr(model, "row_tables") and kind == "pairwise"
        if sparse_req == "auto":
            # The dense path, unless a mesh of several devices would all-reduce
            # more than AUTO_SPARSE_TABLE_BYTES of table gradient each step.
            params = dict(model.named_parameters())
            table_bytes = sum(params[t].numel() * params[t].element_size() for t in model.row_tables()) \
                if sparse_capable else 0
            self.sparse_optim = (sparse_capable and self.mesh is not None and self.mesh.size > 1
                                 and table_bytes > AUTO_SPARSE_TABLE_BYTES)
            if self.sparse_optim:
                print(f"[auto] routing to the row-sharded sparse trainer (row tables {table_bytes / 1e6:.1f} MB > "
                      f"{AUTO_SPARSE_TABLE_BYTES / 1e6:.0f} MB on a {self.mesh.size}-device mesh). "
                      "Set sparse_optim=false to force the dense path.")
        else:
            self.sparse_optim = bool(sparse_req) and sparse_capable
            if sparse_req and not self.sparse_optim:
                print(f"[warn] sparse_optim requested but batch_kind={kind} has no row protocol; "
                      "using the dense path")
        self.sharded = self.sparse_optim and self.mesh is not None
        self.dropped_grad_rows = 0  # the lazy-Adam trainer's dropped count at the last warning
        # The dense trainers' mesh (parallel/data_parallel.py): data shards,
        # and tables row-sharded by default_param_rule on a model axis.
        mesh = None if self.sharded else self.mesh
        neg_sampler = make_negative_sampler(data, model_cfg.get("neg_sampler", "auto"), self.device)
        batch_size = int(model_cfg.get("batch_size", 256))
        if self.sharded:
            from .sparse_optim import ShardedSparseEpochTrainer

            # The bucketed exchange moves n_model / capacity_factor times fewer
            # bytes and is exact while unique owned ids fit; the JAX package
            # makes it the default from a model axis of 4.
            n_model = self.mesh.shape["model"]
            self.epoch_fn = ShardedSparseEpochTrainer(
                model, data.train_arrays(), batch_size, neg_sampler, lr=float(model_cfg.get("lr", 1e-3)),
                mesh=self.mesh, dense_optimizer=lambda params: make_optimizer(model_cfg, params),
                lookup_strategy=model_cfg.get("lookup_strategy", "psum"),
                grad_exchange=model_cfg.get("grad_exchange", "bucketed" if n_model >= 4 else "allgather"),
                capacity_factor=float(model_cfg.get("capacity_factor", 2.0)), compute_dtype=compute_dtype,
            )
            self.optimizer = self.epoch_fn.dense_optimizers[0][0]
            self.lookup_overflow = 0
        elif self.sparse_optim:
            from .sparse_optim import SparseEpochTrainer

            tables = model.row_tables()
            dense = [p for name, p in model.named_parameters() if name not in tables]
            self.optimizer = make_optimizer(model_cfg, dense)
            self.epoch_fn = SparseEpochTrainer(
                model, data.train_arrays(), batch_size, neg_sampler,
                lr=float(model_cfg.get("lr", 1e-3)), dense_optimizer=self.optimizer,
                row_update=model_cfg.get("row_update", "auto"), compute_dtype=compute_dtype,
            )
        elif kind == "sequence":
            self.epoch_fn = SequenceEpochTrainer(
                model, make_optimizer(model_cfg, model.parameters()), data.train_seq_arrays(model.maxlen),
                int(model_cfg.get("batch_size", 128)), neg_sampler, mesh, compute_dtype,
            )
        elif kind == "sequence_time":
            self.epoch_fn = SequenceTimeEpochTrainer(
                model, make_optimizer(model_cfg, model.parameters()),
                data.tisasrec_arrays(model.maxlen, model.time_span), int(model_cfg.get("batch_size", 128)),
                neg_sampler, mesh, compute_dtype,
            )
        elif kind == "prefix":
            self.epoch_fn = PrefixEpochTrainer(
                model, make_optimizer(model_cfg, model.parameters()),
                data.prefix_target_arrays(int(model_cfg.get("maxlen", 19))), int(model_cfg.get("batch_size", 128)),
                mesh, compute_dtype,
            )
        elif kind == "userrow":
            rows = model.artifacts.get("user_rows")
            if rows is None:
                rows = (np.asarray(data.user_item_csr().todense()) > 0).astype(np.float32)
            self.epoch_fn = UserRowEpochTrainer(model, make_optimizer(model_cfg, model.parameters()), rows,
                                                int(model_cfg.get("batch_size", 256)), mesh, compute_dtype)
        elif kind == "triple":
            # The JAX engine draws its triples unseeded; here the run's seed
            # draws them, so a seed repeats bit for bit. Items' negatives
            # follow their train frequencies, users' only with
            # user_neg_weighted (weighting both collapses training).
            triples = data.sample_triples(int(model_cfg.get("n_sample", 100_000)),
                                          time_step=int(model_cfg.get("time_step", 0)), seed=self.seed)
            self.epoch_fn = TripleEpochTrainer(
                model, make_optimizer(model_cfg, model.parameters()), triples, batch_size, data.n_users,
                data.n_items, int(model_cfg.get("n_neg", 5)),
                user_alias=(alias_tables(data.train[DEFAULT_USER_COL], data.n_users, self.device)
                            if model_cfg.get("user_neg_weighted", False) else None),
                item_alias=alias_tables(data.train[DEFAULT_ITEM_COL], data.n_items, self.device), mesh=mesh,
                compute_dtype=compute_dtype,
            )
        elif kind == "none":  # the neighbourhood models: nothing to train, the evaluators sharded
            self.optimizer = make_optimizer(model_cfg, model.parameters())
            self.epoch_fn = None
        else:  # a parameter without requires_grad (BUIR's target) moves by post_update alone
            num_neg = int(getattr(model, "num_neg", model_cfg.get("num_negative", 4)))
            self.epoch_fn = make_epoch_fn(model, make_optimizer(model_cfg, [p for p in model.parameters()
                                                                            if p.requires_grad]),
                                          data.train_arrays(), batch_size, neg_sampler, num_neg, mesh, compute_dtype)
        if self.epoch_fn is not None and not self.sparse_optim:
            self.optimizer = self.epoch_fn.optimizer  # over the mesh's table shards where it has any
        metrics = tuple(sys_cfg.get("metrics", ["ndcg", "precision", "recall", "map"]))
        ks = tuple(sys_cfg.get("k", [5, 10, 20]))
        # As in the JAX package, the per-epoch evaluators score on the mesh,
        # the final test() on one device. Both score on one set of replicas:
        # the data-parallel step's where it keeps them.
        dp = getattr(self.epoch_fn, "dp", None)
        replicas = dp.replicas if dp is not None and dp.mode == "data" else (
            None if self.mesh is None else Replicas(model, [row[0] for row in self.mesh.devices]))
        self.valid_evaluator = (
            RankingEvaluator(model, valid_candidates, metrics, ks, mesh=self.mesh, replicas=replicas)
            if valid_candidates is not None else None
        )
        self.test_evaluator = (
            RankingEvaluator(model, test_candidates, metrics, ks, mesh=self.mesh, replicas=replicas)
            if test_candidates is not None else None
        )
        self.bookkeeper = EvalBookkeeper(
            valid_metric=sys_cfg.get("valid_metric", "ndcg"),
            valid_k=sys_cfg.get("valid_k", 10),
            max_n_update=int(model_cfg.get("max_n_update", MAX_N_UPDATE)),
        )
        return self

    def train(self, max_epoch=None, verbose=True):
        """Epoch loop with early stop, the best checkpoint on improvement and
        ``last/`` every ``system.save_last_every`` epochs (0: only at the end).
        A model with nothing to train (batch kind "none") is evaluated once
        and checkpointed as epoch 0, as in the JAX package. Returns
        {"valid_metric", "best_epoch", "model_save_dir", "run_time"}."""
        max_epoch = max_epoch or int(self.config.model.get("max_epoch", 100))
        save_last_every = int(self.config.system.get("save_last_every", 1))
        start = time.perf_counter()
        self._restore_live()
        if self.epoch_fn is None:  # nothing to train (KNN): evaluate once, checkpoint epoch 0
            valid_result = self.valid_evaluator.evaluate() if self.valid_evaluator else {}
            if valid_result:
                self.bookkeeper.update(0, valid_result)
                self.save_checkpoint(epoch=0)
            self.run_time = time.perf_counter() - start
            return {"valid_metric": self.bookkeeper.best_valid_performance, "best_epoch": 0,
                    "model_save_dir": self.checkpoint_dir, "run_time": self.run_time}
        profiler = self._start_profile() if self.profile_dir else None
        epoch = self.start_epoch - 1
        for epoch in range(self.start_epoch, max_epoch):
            t0 = time.perf_counter()
            loss = float(self.epoch_fn.run(self.generator))  # the epoch's one host read
            self.epoch_seconds.append(time.perf_counter() - t0)
            if self.sparse_optim:
                self._after_sparse_epoch()
            elif self.mesh is not None:
                self.epoch_fn.dp.assemble()
            valid_result = self.valid_evaluator.evaluate() if self.valid_evaluator else {}
            test_result = self.test_evaluator.evaluate() if self.test_evaluator else {}
            improved = self.bookkeeper.update(epoch, valid_result, test_result) if valid_result else False
            if improved:
                self.save_checkpoint(epoch=epoch, kind="best")
            if save_last_every and (epoch + 1) % save_last_every == 0:
                self.save_checkpoint(epoch=epoch, kind="last")
            if profiler is not None and epoch == 1:
                self._write_profile(profiler)
                profiler = None
            if verbose:
                key = self.bookkeeper.key
                print(f"[Epoch {epoch}] loss={loss:.4f} valid_{key}={valid_result.get(key, float('nan')):.4f} "
                      f"({self.epoch_seconds[-1] * 1000:.0f} ms)" + (" *" if improved else ""))
            if valid_result and self.bookkeeper.should_stop:
                if verbose:
                    print(f"Early stop at epoch {epoch} (best epoch {self.bookkeeper.best_epoch})")
                break
        if profiler is not None:
            self._write_profile(profiler)
        if epoch >= self.start_epoch:
            self.save_checkpoint(epoch=epoch, kind="last")
        # A finished train() uses up a resume point: a later train() on this
        # engine runs from epoch 0, as in the JAX package.
        self.start_epoch = 0
        self.run_time = time.perf_counter() - start
        return {
            "valid_metric": self.bookkeeper.best_valid_performance,
            "best_epoch": self.bookkeeper.best_epoch,
            "model_save_dir": self.checkpoint_dir,
            "run_time": self.run_time,
        }

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _write_profile(self, profiler):
        profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(self.profile_dir, "trace.json"))
        return None

    def _make_mesh(self, mesh_cfg):
        """The mesh of ``system.mesh``, or None without one."""
        if not mesh_cfg:
            return None
        from ..parallel.mesh import default_devices, make_mesh

        devices = default_devices(self.device) if self.mesh_devices is None else self.mesh_devices
        if mesh_cfg == "auto":
            mesh = make_mesh(devices=devices)
        else:
            mesh = make_mesh(int(mesh_cfg.get("data", 1)), int(mesh_cfg.get("model", 1)), devices)
        if mesh.devices[0][0] != self.device:
            raise ValueError(f"the mesh starts at {mesh.devices[0][0]}, the model lives on {self.device}")
        return mesh

    def _after_sparse_epoch(self):
        """After every lazy-Adam epoch, warn when gradient rows were dropped
        (never silent): by the bucketed exchange on a mesh or the "compact"
        layout's capacity on one device, as the JAX engine warns after every
        sparse epoch. On a mesh also bring the tables' real rows to the model
        for evaluation, and warn when the ring lookup served batch positions
        as zero rows."""
        if self.sharded:
            self.epoch_fn.assemble()
        dropped = int(self.epoch_fn.dropped)
        if dropped > self.dropped_grad_rows:
            # The JAX engine's words on both paths; the advice is the path's own.
            advice = ("raise model config capacity_factor or set grad_exchange='allgather'" if self.sharded else
                      f"the \"compact\" layout's compact_capacity ({self.epoch_fn.compact_capacity}) is below a "
                      "step's unique ids: raise it or set model config row_update='unified'")
            print(f"WARNING: sharded-sparse bucketed exchange dropped {dropped - self.dropped_grad_rows} gradient "
                  f"rows this epoch (cumulative {dropped}) — {advice}")
        self.dropped_grad_rows = dropped
        if self.sharded:
            overflow = int(self.epoch_fn.lookup_overflow)
            if overflow > self.lookup_overflow:
                print(f"WARNING: sharded-sparse ring lookup served {overflow - self.lookup_overflow} batch positions "
                      f"as zero rows this epoch (cumulative {overflow}) — raise model config capacity_factor or set "
                      "lookup_strategy='psum'")
            self.lookup_overflow = overflow

    # -- checkpoints ----------------------------------------------------------------

    def _param_states(self):
        """{parameter name: its optimizer state, or None} for the parameters
        the optimizer trains, whole-table states where a mesh shards them."""
        if getattr(self.epoch_fn, "dp", None) is not None:
            return self.epoch_fn.dp.named_states()
        names = {id(p): name for name, p in self.model.named_parameters()}
        return {names[id(p)]: self.optimizer.state.get(p) or None
                for group in self.optimizer.param_groups for p in group["params"]}

    def _load_param_states(self, states):
        """Set the optimizer's state from ``{name: state or None}``: through
        the mesh step where there is one, on every replica's optimizer of
        the row-sharded sparse trainer."""
        if getattr(self.epoch_fn, "dp", None) is not None:
            self.epoch_fn.dp.load_named_states(states)
            return
        optimizers = [opt for row in self.epoch_fn.dense_optimizers for opt in row] if self.sharded \
            else [self.optimizer]
        for optimizer in optimizers:
            params = [p for group in optimizer.param_groups for p in group["params"]]
            for p, name in zip(params, self._optimized_names(optimizer)):
                state = states.get(name)
                if state is None:
                    optimizer.state.pop(p, None)
                else:
                    # a copy for each optimizer: the sparse trainer's replicas step their own
                    optimizer.state[p] = {k: v.clone() if k == "step" else v.to(p.device, copy=True).reshape(p.shape)
                                          for k, v in state.items()}

    def _optimized_names(self, optimizer):
        """The model's names of an optimizer's parameters, in its order: the
        row-sharded sparse trainer's replicas hold copies of the model's
        dense parameters, named as replica (0, 0) names them."""
        names = {id(p): name for name, p in self.model.named_parameters()}
        if self.sharded:
            for row in self.epoch_fn.dense:
                for replica in row:
                    names.update({id(p): name for name, p in replica.items()})
        return [names[id(p)] for group in optimizer.param_groups for p in group["params"]]

    def _opt_state_tree(self):
        """The optimizer state in the layout of the JAX package's dense optax
        state for this config ({"0": {"count", "mu", "nu"}, "1": {}} for adam,
        {"0": {"nu"}, "1": {}, "2": {}} for rmsprop (optax 0.2's chain of
        ``scale_by_rms``, an identity and the learning rate), {"0": {}, "1":
        {}} for sgd): the table moments of the lazy-Adam trainer and Adam's
        or rmsprop's state of the other parameters (zeros where a parameter
        has none), nested like the
        params tree (``blocks.0.attn.wq`` -> {"blocks": {"0": {"attn":
        {"wq": ...}}}}; MF's names are flat), so the JAX package's cold
        ``load`` finds the structure it expects. On a mesh the tables and
        their moments are whole and unpadded (the row-sharded sparse
        trainer's padded, as the JAX package's)."""
        optimizer = self.config.model.get("optimizer", "adam")
        states = self._param_states()
        if optimizer == "rmsprop":  # a parameter no step has reached keeps optax's initial 0
            nu = {name: states[name]["nu"].cpu().numpy() if states.get(name)
                  else np.zeros(tuple(p.shape), np.float32) for name, p in self.model.named_parameters()}
            return {"0": {"nu": nest_dotted(nu)}, "1": {}, "2": {}}
        if optimizer != "adam":
            return {"0": {}, "1": {}}
        mu, nu, count = {}, {}, 0
        for name, state in states.items():
            if state:
                mu[name] = state["exp_avg"].detach().cpu().numpy()
                nu[name] = state["exp_avg_sq"].detach().cpu().numpy()
                count = int(state["step"])
        if self.sparse_optim:
            for name, (m, v) in self.epoch_fn.state["moments"].items():
                mu[name], nu[name] = m.cpu().numpy(), v.cpu().numpy()
            count = self.epoch_fn.state["step"]
        # A parameter no gradient reaches (BUIR's target) keeps optax's zero
        # moments, as stop_gradient leaves them in the JAX package.
        for name, p in self.model.named_parameters():
            if name not in mu:
                mu[name] = nu[name] = np.zeros(tuple(p.shape), np.float32)
        return {"0": {"count": np.int32(count), "mu": nest_dotted(mu), "nu": nest_dotted(nu)}, "1": {}}

    def _restore_opt_state(self, tree):
        """Load an optimizer state tree of ``_opt_state_tree``'s layout (the
        JAX package's dense optax state) into the optimizer and, for the
        lazy-Adam trainers, their table moments and step (and the dropped
        count that ``resume_checkpoint`` read), in place. Adam's
        count becomes every parameter's step; a count of 0 leaves the
        optimizer fresh, as optax's initial state is."""
        optimizer = self.config.model.get("optimizer", "adam")
        head = tree["0"]
        names = list(self._param_states())
        if optimizer == "rmsprop":
            nu = flatten_params(head["nu"])
            self._load_param_states({name: {"nu": nu[name]} for name in names})
            return
        if optimizer != "adam":
            return
        count = int(head["count"])
        mu, nu = flatten_params(head["mu"]), flatten_params(head["nu"])
        if self.sparse_optim:
            moments = {name: (mu[name], nu[name]) for name in self.model.row_tables()}
            self.epoch_fn.load_state(moments, count, self.dropped_grad_rows)
        self._load_param_states({name: {"step": torch.tensor(float(count), dtype=torch.float32),
                                        "exp_avg": mu[name], "exp_avg_sq": nu[name]} if count else None
                                 for name in names})

    def resume_checkpoint(self, ckpt_dir=None):
        """Restore the parameters, the optimizer state and the generator from
        a checkpoint directory (this run's best one by default), the port's
        or the JAX package's. On a mesh the restored tables and moments are
        placed on it again, as the JAX package's ``_replace_on_mesh`` places
        them: the row-sharded sparse trainer's padded shards, the dense
        mesh's row shards and replicas."""
        ckpt_dir = ckpt_dir or self.checkpoint_dir
        meta = load_metadata(ckpt_dir)
        if (meta.get("n_users"), meta.get("n_items")) != (self.data.n_users, self.data.n_items):
            raise ValueError(f"the checkpoint at {ckpt_dir} holds {meta.get('n_users')} users x "
                             f"{meta.get('n_items')} items, the data {self.data.n_users} x {self.data.n_items}")
        raw = load_raw_checkpoint(ckpt_dir, backend=self.config.system.get("checkpoint_backend"))
        with torch.no_grad():
            self.model.load_trimmed(flatten_params(raw["params"]))
            if self.sharded:
                self.epoch_fn.place()
            elif getattr(self.epoch_fn, "dp", None) is not None:
                self.epoch_fn.dp.place()
            self.dropped_grad_rows = int(raw.get("dropped", 0))
            self._restore_opt_state(raw["opt_state"])
        state = raw.get("torch_rng")
        if state is not None and np.asarray(state).size == self.generator.get_state().numel():
            self.generator.set_state(torch.as_tensor(np.asarray(state, dtype=np.uint8).copy()))
        else:  # the JAX package's threefry key, or a generator of another device type
            key = np.asarray(raw["rng"], dtype=np.uint32).reshape(-1)
            self.generator.manual_seed((int(key[0]) << 32) | int(key[-1]))
        self.live_state = None
        return self.model

    def resume_training(self, ckpt_dir=None):
        """Restore the full state and the early-stop bookkeeping from
        ``<ckpt_dir>/last`` where it exists, else from ``ckpt_dir`` (this
        run's checkpoint directory by default); ``train()`` then runs from
        the epoch after the restored one. Returns that epoch."""
        ckpt_dir = ckpt_dir or self.checkpoint_dir
        last_dir = os.path.join(ckpt_dir, "last")
        if os.path.exists(last_dir):
            ckpt_dir = last_dir
        self.resume_checkpoint(ckpt_dir)
        meta = load_metadata(ckpt_dir)
        self.bookkeeper.best_valid_performance = float(meta["best_valid_performance"])
        self.bookkeeper.best_epoch = int(meta["best_epoch"])
        self.bookkeeper.n_no_update = int(meta.get("n_no_update", 0))
        self.start_epoch = int(meta.get("epoch", meta["best_epoch"])) + 1
        return self.start_epoch

    # -- serving parameters ---------------------------------------------------------

    def _clone_state(self):
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def hold_best(self):
        """Load the best checkpoint into the model and keep the final-epoch
        parameters aside (``live_state``), once the best exists."""
        if self.live_state is None and self.has_checkpoint("best"):
            self.live_state = self._clone_state()
            self._load_best()

    def _load_best(self):
        with torch.no_grad():
            self.model.load_trimmed(flatten_params(self.load_params()))

    def _restore_live(self):
        if self.live_state is not None:
            self.model.load_state_dict(self.live_state)
            self.live_state = None

    @contextmanager
    def serving(self, use_best=True):
        """Inside the block the model holds the best checkpoint's parameters
        (``use_best`` and one exists) or the final-epoch ones; after it,
        what it held before. Serving never changes the engine's state, so it
        is call-order independent, as in the JAX package."""
        want_best = use_best and self.has_checkpoint("best")
        if want_best == (self.live_state is not None):
            yield self.model
            return
        saved = self._clone_state()
        if want_best:
            self._load_best()
        else:
            self.model.load_state_dict(self.live_state)
        try:
            yield self.model
        finally:
            self.model.load_state_dict(saved)

    def test(self, test_candidates_list, result_para=None, use_best=True, model=None):
        """Evaluate every test candidate copy with the best checkpoint (or,
        ``use_best=False``, the final-epoch parameters); append the mean row
        to the result CSV and, with ``system.save_mode`` "per_user", write
        the first copy's candidates to ``<result_dir>/<model_run_id>
        _per_user.csv``. ``model`` overrides the scoring model (a sequence
        recommender's train+valid context). Returns the mean row."""
        with self.serving(use_best):
            return final_test(self.config, model or self.model, test_candidates_list, self.model_run_id,
                              result_para, self.run_time)

    def save_checkpoint(self, epoch=None, kind="best"):
        """``kind="best"`` writes ``<checkpoint_dir>/`` (the best-valid model,
        what serving restores); ``kind="last"`` writes ``<checkpoint_dir>/last/``.
        The file holds ``params`` in the JAX layout, the optimizer state
        (``_opt_state_tree``), ``rng`` (key data) and ``torch_rng`` (the
        generator's state); a lazy-Adam run also ``dropped``, the JAX sparse
        state's count of dropped gradient rows (beside the optax tree, whose
        named tuples the JAX package's load holds to their fields)."""
        ckpt_dir = self.checkpoint_dir if kind == "best" else os.path.join(self.checkpoint_dir, "last")
        # A sharded run writes its row tables padded to the model axis, as the
        # JAX package does.
        params = self.epoch_fn.padded_params() if self.sharded else self.model.state_dict()
        generator_state = self.generator.get_state().numpy()
        dropped = {"dropped": np.int32(int(self.epoch_fn.dropped))} if self.sparse_optim else {}
        save_checkpoint(ckpt_dir, {
            "params": params_to_jax(params),
            "opt_state": self._opt_state_tree(),
            "rng": _key_data(generator_state),
            "torch_rng": generator_state,
            **dropped,
        }, backend=self.config.system.get("checkpoint_backend", "flax"))
        save_metadata(ckpt_dir, {
            "kind": kind,
            "best_valid_performance": self.bookkeeper.best_valid_performance,
            "best_epoch": self.bookkeeper.best_epoch,
            "n_no_update": self.bookkeeper.n_no_update,
            "epoch": self.bookkeeper.best_epoch if epoch is None else epoch,
            "model_run_id": self.model_run_id,
            "n_users": self.data.n_users,
            "n_items": self.data.n_items,
            "config": self.config.to_dict(),
        })

    def has_checkpoint(self, kind="best"):
        ckpt_dir = self.checkpoint_dir if kind == "best" else os.path.join(self.checkpoint_dir, "last")
        return os.path.exists(os.path.join(ckpt_dir, "checkpoint.msgpack"))

    def load_params(self, ckpt_dir=None):
        """The params tree of a checkpoint (the best one by default)."""
        return load_raw_checkpoint(ckpt_dir or self.checkpoint_dir,
                                   backend=self.config.system.get("checkpoint_backend"))["params"]
