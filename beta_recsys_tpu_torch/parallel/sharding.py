"""Parameter and batch placement rules, and the sharded train step.

Counterpart of ``beta_recsys_tpu/parallel/sharding.py``. A placement is a
spec tuple, as ``PartitionSpec`` names one: ``ROW_SHARDED`` (``P("model",
None)``) or ``REPLICATED`` (``P()``). A placed tensor is the nested list
``placed[d][m]`` of what shard (d, m) holds, on ``mesh.devices[d][m]``: a
row shard of the table padded to the model axis (``embedding.shard_table``)
or a whole copy.
"""

import numpy as np

from .embedding import shard_table
from .mesh import DATA_AXIS, MODEL_AXIS

ROW_SHARDED = (MODEL_AXIS, None)
REPLICATED = ()
MIN_SHARDED_ROWS = 1024  # the JAX rule's least table height to row-shard


def default_param_rule(n_users, n_items, min_rows=None):
    """Sharding rule: row-shard big per-user/per-item tables over "model".

    A 2-D tensor whose leading dimension is ``n_users`` or ``n_items`` and
    at least ``min_rows`` (``MIN_SHARDED_ROWS``) is ``ROW_SHARDED``; any
    other parameter (dense layers, biases, scalars, a sequence model's
    (n_items + 1)-row table) is ``REPLICATED``, as in the JAX package."""
    min_rows = MIN_SHARDED_ROWS if min_rows is None else min_rows

    def rule(tensor):
        if tensor.dim() == 2 and tensor.shape[0] in (n_users, n_items) and tensor.shape[0] >= min_rows:
            return ROW_SHARDED
        return REPLICATED

    return rule


def shard_params(params, mesh, rule):
    """{name: placed[d][m]} for a {name: tensor} dict, per the rule."""

    def place(tensor):
        tensor = tensor.detach()
        if rule(tensor) == ROW_SHARDED:
            return shard_table(tensor, mesh)
        return [[tensor.to(device, copy=True) for device in row] for row in mesh.devices]

    return {name: place(tensor) for name, tensor in params.items()}


def shard_batch(batch, mesh):
    """{name: placed[d][m]}: each batch tensor's leading dim split over
    "data" (shard d's rows on every device of data row d)."""
    n_data = mesh.shape[DATA_AXIS]

    def place(tensor):
        if tensor.shape[0] % n_data:
            raise ValueError(f"a batch of {tensor.shape[0]} rows does not split over {n_data} data shards")
        local = tensor.reshape(n_data, -1, *tensor.shape[1:])
        return [[local[d].to(device) for device in row] for d, row in enumerate(mesh.devices)]

    return {name: place(tensor) for name, tensor in batch.items()}


def pad_to_multiple(arr, multiple, axis=0):
    """Pad an array along ``axis`` so its size divides ``multiple`` (wraps data)."""
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr
    reps = -(-target // n)
    tiled = np.concatenate([arr] * reps, axis=axis)
    return np.take(tiled, np.arange(target), axis=axis)


def make_sharded_train_step(model, optimizer, mesh, param_rule=None):
    """(step, place) for one train step of ``model`` on the mesh: ``step(batch,
    generator=None) -> loss`` takes a gradient step of the whole batch
    (``data_parallel.DataParallelStep``: the model's tables row-sharded per
    ``param_rule``, default ``default_param_rule``, on a model axis of more
    than one device; on a pure data axis each shard's rows and one
    all-reduce); ``place()`` places the model's current parameters on the
    mesh again. ``step.optimizer`` is ``optimizer`` rebuilt over the placed
    parameters."""
    from .data_parallel import DataParallelStep

    step = DataParallelStep(model, optimizer, mesh, param_rule=param_rule)
    return step, step.place
