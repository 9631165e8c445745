"""Row-sharded embedding tables with explicit collective lookup.

Counterpart of ``beta_recsys_tpu/parallel/embedding.py``. A table is
row-sharded over the "model" axis and replicated over "data", as
``P("model", None)`` places it: ``shard_table`` gives the nested list
``shards[d][m]``, model shard ``m``'s rows on ``mesh.devices[d][m]``. Where the
JAX package runs a ``shard_map`` body once per shard, one controller runs it
here for each shard of a data row's model group, on that shard's device.

The ``local_*`` primitives take one model group: the list of its table shards
and the list of its ids, one per shard on the shard's device, and return one
result per shard. The mesh-level lookups return ``out[d][m]``, the output as
shard (d, m) holds it. Two strategies, as in the JAX package:
  - psum: each shard keeps the rows it owns (zeros elsewhere) and one psum
    over "model" completes them (``local_psum_gather``);
  - bucketed: each shard serves only its owned ids, up to a capacity a shard
    (``bucket_positions``); overflow ids come back as zero rows. The response
    leg is a psum (``bucketed_psum_gather``) or the hand-written ring
    all-gather kernel (``local_ring_gather``, ``rdma_bucketed_gather``).
Gradients flow by autograd: the ring's backward is its reduce-scatter.
"""

import torch
import torch.nn.functional as F

from ..ops.kernels.ring_exchange import ring_allgather
from .collectives import psum
from .mesh import DATA_AXIS, MODEL_AXIS


def _local_rows(n_rows, axis_size):
    """Rows per shard (tables are padded to a multiple of the axis size)."""
    return -(-n_rows // axis_size)


def pad_table(table, axis_size):
    """Pad an (N, ...) table with zero rows so N divides the model-axis size."""
    n = table.shape[0]
    target = _local_rows(n, axis_size) * axis_size
    if target == n:
        return table
    return torch.cat([table, table.new_zeros((target - n, *table.shape[1:]))])


def shard_table(table, mesh):
    """``shards[d][m]``: rows ``m * rows_per:(m + 1) * rows_per`` of the padded
    table, a copy of its own on ``mesh.devices[d][m]``."""
    parts = pad_table(table, mesh.shape[MODEL_AXIS]).chunk(mesh.shape[MODEL_AXIS])
    return [[parts[m].to(device, copy=True) for m, device in enumerate(row)] for row in mesh.devices]


def _owned(local_table, ids, shard_idx):
    """Rows of global ``ids`` from model shard ``shard_idx``'s slice, zero
    where another shard owns the id."""
    rows_per = local_table.shape[0]
    local = ids - shard_idx * rows_per
    in_range = (local >= 0) & (local < rows_per)
    rows = local_table[local.clamp(0, rows_per - 1)]
    mask = in_range[..., None] if rows.dim() > in_range.dim() else in_range
    return torch.where(mask, rows, 0.0)


def local_psum_gather(local_tables, ids):
    """One model group's lookup of global ``ids`` with ONE psum over "model":
    shard m contributes the rows it owns. ``local_tables[m]`` is shard m's
    (rows_per, d) or (rows_per,) slice and ``ids[m]`` the same ids on its
    device. The single implementation behind ``psum_gather``,
    ``psum_gather_sharded_batch`` and the sharded trainer's psum lookup."""
    return psum([_owned(t, i, m) for m, (t, i) in enumerate(zip(local_tables, ids))])


def bucket_positions(ids, n_model, capacity, rows_per_shard):
    """Owner-bucketed routing table for a batch of global row ids: an
    (n_model, capacity) int64 tensor whose [s, c] is the batch index that model
    shard ``s`` serves in slot ``c``, or len(ids) for empty and overflow slots.
    Shared by every bucketed exchange, so capacity and overflow cannot drift
    apart."""
    b = ids.shape[0]
    owner = ids // rows_per_shard
    slot = F.one_hot(owner, n_model).cumsum(0)[torch.arange(b, device=ids.device), owner] - 1
    write = torch.where(slot < capacity, slot, capacity)  # column `capacity` is cut off below
    positions = torch.full((n_model, capacity + 1), b, dtype=torch.long, device=ids.device)
    positions[owner, write] = torch.arange(b, device=ids.device)
    return positions[:, :capacity]


def _bucket(local_table, ids, shard_idx, positions):
    """Shard ``shard_idx``'s bucket: the rows it owns at its slots of
    ``positions`` (zero rows at empty slots), and each slot's batch index
    (0 at empty slots) with its validity."""
    b = ids.shape[0]
    rows_per = local_table.shape[0]
    my_pos = positions[shard_idx]
    req_valid = my_pos < b
    safe_pos = torch.where(req_valid, my_pos, 0)
    local = ids[safe_pos] - shard_idx * rows_per
    ok = (local >= 0) & (local < rows_per) & req_valid
    rows = local_table[local.clamp(0, rows_per - 1)]
    return torch.where(ok[:, None], rows, 0.0), safe_pos, req_valid


def local_ring_gather(local_tables, ids, n_model, capacity):
    """One model group's bucketed lookup whose response leg is the ring
    all-gather kernel: each shard serves a bucket of ``capacity`` owned rows,
    the buckets ride the ring, and every shard scatters the n_model buckets
    back to batch positions. Overflow ids give zero rows. The single
    implementation behind ``rdma_bucketed_gather`` and the sharded trainer's
    ring lookup."""
    b = ids[0].shape[0]
    d = local_tables[0].shape[1]
    rows_per = local_tables[0].shape[0]
    buckets, flat_positions = [], []
    for m, (table, i) in enumerate(zip(local_tables, ids)):
        positions = bucket_positions(i, n_model, capacity, rows_per)
        buckets.append(_bucket(table, i, m, positions)[0])
        flat_positions.append(positions.reshape(-1))
    out = []
    for pos, rows in zip(flat_positions, ring_allgather(buckets)):
        # Empty slots carry position b: a dump row, cut off.
        full = rows.new_zeros((b + 1, d)).index_add(0, pos, rows.reshape(n_model * capacity, d))
        out.append(full[:b])
    return out


def _replicated(ids, mesh):
    """[[ids on devices[d][m]]]: a replicated batch."""
    return [[ids.to(device) for device in row] for row in mesh.devices]


def _data_sharded(ids, mesh):
    """[[data shard d of ids on devices[d][m]]]: a batch sharded over "data"."""
    n_data = mesh.shape[DATA_AXIS]
    if ids.shape[0] % n_data:
        raise ValueError(f"a batch of {ids.shape[0]} ids does not split over {n_data} data shards")
    local = ids.view(n_data, -1, *ids.shape[1:])
    return [[local[d].to(device) for device in row] for d, row in enumerate(mesh.devices)]


def psum_gather(shards, ids, mesh):
    """Sharded-table lookup, ids replicated: ``out[d][m]`` is (..., d) rows."""
    return [local_psum_gather(shards[d], row_ids) for d, row_ids in enumerate(_replicated(ids, mesh))]


def psum_gather_sharded_batch(shards, ids, mesh):
    """Sharded-table lookup with the (B,) id batch sharded over "data":
    ``out[d][m]`` holds data shard d's (B / n_data, dim) rows."""
    return [local_psum_gather(shards[d], row_ids) for d, row_ids in enumerate(_data_sharded(ids, mesh))]


def bucketed_psum_gather(shards, ids, mesh, capacity_factor=2.0):
    """Bucketed lookup, ids sharded over "data": each data shard buckets its
    local ids by owner (C = ceil(local_B / n_model) * capacity_factor;
    overflow ids give zero rows), each model shard gathers only its bucket and
    scatters it to the requesting positions, and one psum over "model"
    assembles the batch. ``out[d][m]`` holds data shard d's rows."""
    n_model = mesh.shape[MODEL_AXIS]
    out = []
    for d, row_ids in enumerate(_data_sharded(ids, mesh)):
        parts = []
        for m, (table, local_ids) in enumerate(zip(shards[d], row_ids)):
            local_b = local_ids.shape[0]
            capacity = max(int(-(-local_b // n_model) * capacity_factor), 1)
            positions = bucket_positions(local_ids, n_model, capacity, table.shape[0])
            rows, safe_pos, req_valid = _bucket(table, local_ids, m, positions)
            scattered = rows.new_zeros((local_b, table.shape[1]))
            parts.append(scattered.index_add(0, safe_pos, torch.where(req_valid[:, None], rows, 0.0)))
        out.append(psum(parts))
    return out


def rdma_bucketed_gather(shards, ids, mesh, capacity_factor=2.0):
    """Bucketed lookup whose response leg is the ring all-gather kernel
    instead of a psum; the contract of ``psum_gather`` (ids replicated,
    ``out[d][m]`` the (B, dim) rows). C = ceil(B / n_model) * capacity_factor,
    8-aligned; overflow ids give zero rows. Gradients: the ring's
    reduce-scatter, then a scatter-add into each table shard."""
    n_model = mesh.shape[MODEL_AXIS]
    b = ids.shape[0]
    capacity = max(int(-(-b // n_model) * capacity_factor), 1)
    capacity = -(-capacity // 8) * 8
    return [local_ring_gather(shards[d], row_ids, n_model, capacity)
            for d, row_ids in enumerate(_replicated(ids, mesh))]
