"""The dense trainers' step on a ("data", "model") mesh.

Counterpart of ``_make_grad_fn``, ``_mesh_round_batch``, ``_mesh_shard_batch``
and ``_pointwise_prepare`` in ``beta_recsys_tpu/core/train_engine.py``. Every
dense trainer of ``core/train_engine.py`` takes its optimizer step through a
``DataParallelStep``, which keeps the JAX package's two meanings of a mesh:

  (N, 1), its ``shard_map`` - data shard d runs the model's loss and
      gradient on its own B/N rows, on its own device (the pointwise batch
      expanded there, ``pointwise_prepare``). Each shard draws from a
      generator holding the epoch generator's state at the step, as every
      shard of ``shard_map`` draws from the replicated key; shard 0 draws from
      the epoch generator itself, which then stands where one step's draws
      leave it. The shards' losses and gradients are kept apart, then go
      through ONE flat-buffer ``pmean`` in rank order (``pmean_flat``). A loss
      that couples a batch's rows (InfoNCE, a mean over non-pad positions) is
      therefore the mean of the shards' losses, as in the JAX package. The
      optimizer steps once, ``post_update`` runs once, and the replicas on
      other devices receive the updated parameters;
  (N, M > 1), its partitioner - the loss is the whole batch's, as on one
      device. Each trained table that the param rule (``default_param_rule``)
      row-shards lives padded (``pad_table``) as M row shards on the model
      devices of data row 0, with its optimizer moments beside them; the
      forward pass assembles it with the ring all-gather kernel
      (``ring_allgather``), whose backward hands each shard its rows'
      gradient. The other parameters update as on one device. ``assemble()``
      copies the tables' real rows into the model.

A mesh of one device, or none, is the one-device step: zero_grad, loss,
backward, optimizer step, ``post_update``. With ``compute_dtype`` every mode
computes its loss through ``loss_with_dtype`` (``core/mixed_precision.py``):
the parameters, gathered tables included, cast down inside the step, the
gradients and moments float32.
"""

import copy

import torch
from torch import nn

from ..core.mixed_precision import loss_with_dtype
from ..ops.kernels.ring_exchange import ring_allgather
from .collectives import pmean_flat, record
from .embedding import pad_table
from .mesh import DATA_AXIS, MODEL_AXIS
from .sharding import ROW_SHARDED, default_param_rule


def mesh_round_batch(batch_size, mesh):
    """Round a (clamped) batch size down to a multiple of the data-axis size,
    so batch shards are even (``_mesh_round_batch``)."""
    if mesh is None:
        return batch_size
    n_data = mesh.shape[DATA_AXIS]
    return max(batch_size // n_data, 1) * n_data


def pointwise_prepare(batch):
    """Raw pointwise fields {"u", "it", "neg", "r"} (B positives, their B *
    num_neg negatives together) -> the model's {"users", "items", "labels"}:
    the positives with their ratings, then the negatives labelled 0."""
    u, it, neg, r = batch["u"], batch["it"], batch["neg"], batch["r"]
    num_neg = neg.shape[0] // u.shape[0]
    return {"users": torch.cat([u, u.repeat_interleave(num_neg)]), "items": torch.cat([it, neg]),
            "labels": torch.cat([r, r.new_zeros(neg.shape)])}


_MODULE_KEYS = frozenset(vars(nn.Module()))


def _moved(value, device):
    """``value`` with every tensor it holds on ``device``: tensors, lists,
    tuples, dicts, and this package's plain objects (propagators) copied."""
    if torch.is_tensor(value):
        return value.to(device)
    if isinstance(value, (list, tuple)) and not hasattr(value, "_fields"):
        return type(value)(_moved(v, device) for v in value)
    if type(value) is dict:
        return {k: _moved(v, device) for k, v in value.items()}
    if (type(value).__module__.startswith(__package__.split(".")[0]) and hasattr(value, "__dict__")
            and not isinstance(value, nn.Module)):
        moved = copy.copy(value)
        _move_attributes(moved, vars(value), device)
        return moved
    return value


def _move_attributes(obj, attributes, device):
    for key, value in attributes.items():
        vars(obj)[key] = device if key == "device" else _moved(value, device)


def replica(model, device):
    """A copy of ``model`` whose parameters, buffers and tensor attributes
    (adjacency operators, sequence contexts) live on ``device``."""
    clone = copy.deepcopy(model).to(device)
    for module in clone.modules():
        _move_attributes(module, {k: v for k, v in vars(module).items() if k not in _MODULE_KEYS}, device)
    return clone


class Replicas:
    """The model on each distinct device of ``devices``: the model itself on
    its own device, a ``replica`` on each other one. ``sync()`` copies the
    model's parameters and buffers into the replicas (counted as one
    broadcast when there are any)."""

    def __init__(self, model, devices):
        self.model = model
        self.by_device = {model.device: model}
        for device in devices:
            if device not in self.by_device:
                self.by_device[device] = replica(model, device)

    def __getitem__(self, device):
        return self.by_device[device]

    @torch.no_grad()
    def sync(self):
        others = [m for m in self.by_device.values() if m is not self.model]
        if not others:
            return
        source = list(self.model.state_dict(keep_vars=True).values())
        for other in others:
            for src, dst in zip(source, other.state_dict(keep_vars=True).values()):
                dst.copy_(src)
        record("broadcast", sum(t.numel() * t.element_size() for t in source))


def _shard_generator(generator, state, d, device):
    if generator is None:
        return None
    if d == 0 and generator.device == device:
        return generator
    clone = torch.Generator(device=device)
    clone.set_state(state)
    return clone


class DataParallelStep:
    """One optimizer step of ``model.loss`` on a batch, on ``mesh`` (None: one
    device). ``step(batch, generator=None)`` takes a dict of (B, ...) tensors
    on the model's device, applies ``prepare`` to it (to each data shard's
    rows on a data axis) and returns the step's loss as a 0-d tensor there.
    ``post_update`` (BUIR's target EMA) runs after each optimizer step.
    ``optimizer`` is the optimizer the step uses: on a model axis that shards
    a table, ``optimizer`` rebuilt (its class and defaults) over the
    unsharded parameters and the table shards. ``compute_dtype``
    ("bfloat16") runs the loss in that type over float32 master weights."""

    def __init__(self, model, optimizer, mesh=None, param_rule=None, prepare=None, post_update=None,
                 compute_dtype=None):
        self.model, self.optimizer, self.mesh = model, optimizer, mesh
        self.prepare, self.post_update = prepare, post_update
        self.loss_fn = loss_with_dtype(model, compute_dtype)
        self.tables, self.n_rows = {}, {}
        self.mode = "local" if mesh is None or mesh.size == 1 else (
            "data" if mesh.shape[MODEL_AXIS] == 1 else "model")
        if self.mode == "local":
            return
        if mesh.devices[0][0] != model.device:
            raise ValueError(f"the model lives on {model.device}, the mesh starts at {mesh.devices[0][0]}")
        names = {id(p): name for name, p in model.named_parameters()}
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        if self.mode == "data":
            self.devices = [row[0] for row in mesh.devices]
            self.replicas = Replicas(model, self.devices)
            self.shard_loss = {device: loss_with_dtype(m, compute_dtype)
                               for device, m in self.replicas.by_device.items()}
            self.shard_params = {device: [dict(m.named_parameters())[names[id(p)]] for p in self.params]
                                 for device, m in self.replicas.by_device.items()}
            return
        self.n_model = mesh.shape[MODEL_AXIS]
        self.model_devices = mesh.devices[0]
        rule = param_rule or default_param_rule(model.n_users, model.n_items)
        for p in self.params:
            if rule(p) == ROW_SHARDED:
                name = names[id(p)]
                parts = pad_table(p.detach(), self.n_model).chunk(self.n_model)
                self.tables[name] = [nn.Parameter(part.to(device, copy=True))
                                     for part, device in zip(parts, self.model_devices)]
                self.n_rows[name] = p.shape[0]
        if self.tables:
            sharded = {id(p) for p in self.params if names[id(p)] in self.tables}
            kept = [p for p in self.params if id(p) not in sharded]
            self.optimizer = type(optimizer)(kept + [s for shards in self.tables.values() for s in shards],
                                             **optimizer.defaults)

    def __call__(self, batch, generator=None):
        if self.mode == "data":
            return self._data_step(batch, generator)
        if self.prepare is not None:
            batch = self.prepare(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch, generator, self._gathered())
        loss.backward()
        self.optimizer.step()
        self._post_update()
        return loss.detach()

    def _gathered(self):
        """{table name: the whole table}, assembled from its row shards by
        the ring all-gather kernel, on the model's device (float32: a cast
        to the compute dtype follows the gather)."""
        out = {}
        for name, shards in self.tables.items():
            blocks = ring_allgather(shards)[0]  # (M, rows a shard, d), data row 0's first device
            out[name] = blocks.reshape(-1, blocks.shape[-1])[: self.n_rows[name]]
        return out

    def _data_step(self, batch, generator):
        n = len(self.devices)
        parts = {key: value.chunk(n) for key, value in batch.items()}
        state = None if generator is None else generator.get_state()
        results = []
        for d, device in enumerate(self.devices):
            local = {key: value[d].to(device) for key, value in parts.items()}
            if self.prepare is not None:
                local = self.prepare(local)
            loss = self.shard_loss[device](local, _shard_generator(generator, state, d, device))
            grads = torch.autograd.grad(loss, self.shard_params[device], allow_unused=True)
            results.append((loss.detach(), grads))
        used = [g is not None for g in results[0][1]]
        means = pmean_flat([[loss, *(g for g in grads if g is not None)] for loss, grads in results])
        self.optimizer.zero_grad(set_to_none=True)
        reduced = iter(means[1:])
        for p, has_grad in zip(self.params, used):
            if has_grad:
                p.grad = next(reduced)
        self.optimizer.step()
        self._post_update()
        self.replicas.sync()
        return means[0]

    def _post_update(self):
        if self.post_update is not None:
            self.assemble()
            with torch.no_grad():
                self.post_update()

    # -- the placed state ----------------------------------------------------------

    @torch.no_grad()
    def assemble(self):
        """Copy the row-sharded tables' real rows into the model, which then
        holds what the mesh holds."""
        params = dict(self.model.named_parameters())
        for name, shards in self.tables.items():
            params[name].copy_(torch.cat([s.to(self.model.device) for s in shards])[: self.n_rows[name]])

    @torch.no_grad()
    def place(self):
        """Place the model's current parameters on the mesh again: the table
        shards from the model's tables, the replicas from the model."""
        params = dict(self.model.named_parameters())
        for name, shards in self.tables.items():
            for shard, part in zip(shards, pad_table(params[name].detach(), self.n_model).chunk(self.n_model)):
                shard.copy_(part)
        if self.mode == "data":
            self.replicas.sync()

    def named_states(self):
        """{parameter name: its optimizer state, or None before its first
        step} for the parameters the optimizer trains; a row-sharded table's
        state assembled from its shards and cut to the table's rows."""
        names = {id(p): name for name, p in self.model.named_parameters()}
        states = {}
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if id(p) in names:
                    states[names[id(p)]] = self.optimizer.state.get(p) or None
        for name, shards in self.tables.items():
            parts = [self.optimizer.state.get(s) for s in shards]
            states[name] = None if not parts[0] else {
                key: torch.cat([part[key].to(self.model.device) for part in parts])[: self.n_rows[name]]
                if torch.is_tensor(value) and value.dim() else value
                for key, value in parts[0].items()}
        return states

    @torch.no_grad()
    def load_named_states(self, states):
        """Set the optimizer's state from ``{name: state or None}`` (whole
        tables' states row-sharded as their tables are; each shard its own
        copy of the step count)."""
        params = dict(self.model.named_parameters())
        trained = {id(p) for group in self.optimizer.param_groups for p in group["params"]}
        for name, state in states.items():
            shards = self.tables.get(name)
            targets = [params[name]] if shards is None else shards
            for m, target in enumerate(targets):
                if id(target) not in trained:
                    continue
                if state is None:
                    self.optimizer.state.pop(target, None)
                    continue
                self.optimizer.state[target] = {
                    key: value.clone() if key == "step" else (
                        value.to(target.device, copy=True).reshape(target.shape) if shards is None else
                        pad_table(value, self.n_model).chunk(self.n_model)[m].to(target.device, copy=True))
                    for key, value in state.items()}
