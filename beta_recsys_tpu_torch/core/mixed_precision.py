"""Mixed precision: a low-precision forward and backward over float32 master
weights.

Counterpart of ``_loss_with_dtype`` in ``beta_recsys_tpu/core/train_engine.py``
and of the cast in its lazy-Adam trainers. With ``compute_dtype``
("bfloat16") every floating parameter is cast down inside the differentiated
function, so the whole forward runs in that type; the loss is cast to float32.
Autograd carries each gradient back up through the cast, as ``astype``'s VJP
does, so the parameters, their gradients and the optimizer moments stay
float32. Only the parameters are cast: artifacts (adjacency operators,
contexts, constraint weights) stay float32, and where the JAX package promotes
a product of the two to float32 the models cast explicitly, since a torch
matmul raises on mixed types.

This is not ``torch.autocast``: autocast keeps layer norm, softmax and
reductions in float32 and picks its own ops, which computes another function.
"""

import torch
from torch import nn
from torch.func import functional_call

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def compute_dtype_of(config):
    """The run's compute dtype name, or None: ``model.compute_dtype``, else
    ``system.compute_dtype``, as the JAX engine reads it."""
    return config.model.get("compute_dtype", config.system.get("compute_dtype"))


def torch_dtype(compute_dtype):
    """The torch dtype of a compute dtype name (None stays None)."""
    if compute_dtype is None:
        return None
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; use one of {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[compute_dtype]


def cast_floating(tensors, dtype):
    """``tensors`` (a dict) with every floating tensor cast to ``dtype``."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}


def promoted(*tensors):
    """The tensors in their promoted floating type, as JAX promotes the
    operands of a product of mixed floating types (bfloat16 with float32 ->
    float32); torch's matmul and sparse products raise on mixed types."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)


class _Loss(nn.Module):
    """``model.loss`` as a module call, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch, generator):
        return self.model.loss(batch, generator)


def loss_with_dtype(model, compute_dtype):
    """fn(batch, generator=None, params=None) -> the step's loss.

    ``params`` replaces parameters by name (the mesh step's gathered tables).
    With ``compute_dtype`` every floating parameter, replaced or not, is cast
    to it inside the call and the loss comes back float32; without one the
    model's own loss runs on its own parameters."""
    dtype = torch_dtype(compute_dtype)
    wrapper = _Loss(model)

    def loss_fn(batch, generator=None, params=None):
        if dtype is None and not params:
            return model.loss(batch, generator)
        named = {f"model.{name}": p for name, p in model.named_parameters()}
        named.update({f"model.{name}": p for name, p in (params or {}).items()})
        if dtype is None:
            return functional_call(wrapper, named, (batch, generator))
        return functional_call(wrapper, cast_floating(named, dtype), (batch, generator)).float()

    return loss_fn


def row_loss_with_dtype(model, compute_dtype):
    """fn(rows, dense, batch) -> ``model.row_loss`` with the gathered rows
    and the dense parameters cast to ``compute_dtype`` and the loss float32,
    as the JAX lazy-Adam trainers cast them; the row gradients come back
    float32 into the row update."""
    dtype = torch_dtype(compute_dtype)
    if dtype is None:
        return model.row_loss

    def row_loss(rows, dense, batch):
        return model.row_loss(cast_floating(rows, dtype), cast_floating(dense, dtype), batch).float()

    return row_loss
