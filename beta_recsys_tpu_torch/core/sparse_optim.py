"""Sparse (lazy) Adam for embedding tables: gradients with respect to the
gathered rows, Adam moments and parameters updated only at the touched ids.

Counterpart of ``beta_recsys_tpu/core/sparse_optim.py`` (``_segment_dedup``,
``sparse_adam_row_update``, ``init_sparse_state``, ``make_sparse_epoch_fn``,
one device). Semantics are TF-style lazy Adam: the bias-correction step count
is global over the whole run, and the gradient rows of an id that occurs
several times in a batch are summed before one moment update.

``row_update`` picks how the tables' rows are written back:
  "fused"   - the ``fused_rowadam`` CUDA kernel (``ops/kernels/rowadam.py``),
    in place, one launch a step for every 2-D table (``RowAdamTables``, its
    tables and moments checked once); on CPU tensors its plain version;
  "xla"     - ``sparse_adam_row_update``: gather, torch arithmetic, index_add_;
  "unified" - every table in ONE (total_rows, 3*w_max) float32 [param|m|v]
    array, packed at the start of an epoch (``run``/``run_batches``) and
    unpacked into the model and ``state["moments"]`` at its end: roles
    stacked at row offsets, a role's tables side by side (1-D biases as
    width-1 columns). A step gathers the packed ids' parameter columns once,
    takes autograd with respect to that one (L, w_max) leaf, dedups once and
    writes once through ``fused_rowadam_packed`` (one launch; its plain
    version on the CPU). Each table's "touched" mask stays its own;
  "compact" - "unified" whose write keeps at most ``compact_capacity`` (C)
    unique rows a step, the first C of the sorted packed ids; the others lose
    that step's gradient, counted in ``state["dropped"]``. C defaults to the
    JAX package's host estimate of a batch's unique ids x 1.25
    (``compact_capacity_estimate``);
  "unified_bf16" - the 2-D tables in ONE (total_rows, 4*w_max) int16 array of
    [p_hi|p_lo|m_bf16|v_bf16] rows (``fused_rowadam_packed_bf16``): float32
    master weights bit-exact, Adam moments rounded to bfloat16, half the
    optimizer state's bytes; the 1-D biases take ``sparse_adam_row_update``;
  "auto"    - "fused" where the tables are on the card, "xla" on the CPU: as
    the JAX package takes its kernel where one exists (the TPU) and "xla"
    elsewhere.
Under "fused" and "xla" the 1-D bias tables take ``sparse_adam_row_update``.
Tables and moments are updated in place.

``ShardedSparseEpochTrainer`` is the counterpart of
``make_sharded_sparse_epoch_fn``: the same lazy Adam with tables and moments
row-sharded over a mesh's "model" axis and batches over "data".
"""

import contextlib

import numpy as np
import torch

from ..ops.kernels.rowadam import (
    RowAdamPacked,
    RowAdamTables,
    adam_rows,
    bias_corrections,
    bias_denominators,
    repack16,
    unpack16_components,
)
from ..parallel.collectives import all_gather, psum
from ..parallel.embedding import local_psum_gather, local_ring_gather, shard_table
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from .mixed_precision import row_loss_with_dtype
from .train_engine import EpochBatches

PACKED_LAYOUTS = ("unified", "compact", "unified_bf16")
ROW_UPDATES = ("fused", "xla", *PACKED_LAYOUTS)


def _segment_dedup(ids, rows):
    """Sum the gradient rows of duplicate ids: returns (sorted ids, rows)
    of the same length L, the sum at each id's first occurrence and zero
    rows at the others. Fixed length, so nothing is read on the host. The
    sums go through ``index_put_(accumulate=True)``, which adds in a fixed
    order on CUDA (``index_add_`` adds with atomics), so a run on the card
    repeats bit for bit."""
    sorted_ids, order = torch.sort(ids, stable=True)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(first, 0) - 1
    summed = torch.zeros_like(rows).index_put_((seg,), rows[order], accumulate=True)
    keep = first.view(-1, *([1] * (rows.dim() - 1)))
    return sorted_ids, torch.where(keep, summed[seg], 0.0)


def sparse_adam_row_update(table, m, v, ids, grad_rows, lr, step, b1=0.9, b2=0.999, eps=1e-8):
    """One lazy-Adam update of the rows ``ids`` of (table, m, v), in place;
    returns them. 1-D tables (biases) are handled as one-column matrices."""
    one_d = table.dim() == 1
    t2, m2, v2 = (x[:, None] if one_d else x for x in (table, m, v))
    ids, grad_rows = _segment_dedup(ids, grad_rows[:, None] if one_d else grad_rows)
    m_rows, v_rows = m2[ids], v2[ids]
    delta, m_new, v_new = adam_rows(m_rows, v_rows, grad_rows, bias_corrections(step, b1, b2), lr, b1, b2, eps)
    # Duplicate occurrences carry zero rows and would add pure-momentum
    # deltas: mask them so each unique row updates once. Every write adds a
    # delta, so the order of duplicate ids cannot matter.
    touched = (grad_rows != 0).any(dim=1, keepdim=True)
    t2.index_add_(0, ids, torch.where(touched, delta, 0.0))
    m2.index_add_(0, ids, torch.where(touched, m_new - m_rows, 0.0))
    v2.index_add_(0, ids, torch.where(touched, v_new - v_rows, 0.0))
    return table, m, v


def init_sparse_state(params, table_names):
    """Zero Adam moments for the sparse tables, the global step count and
    ``dropped`` (a 0-d tensor on the tables' device: the unique ids whose
    gradient a step dropped at the compact layout's capacity, over the run)."""
    moments = {name: (torch.zeros_like(params[name]), torch.zeros_like(params[name])) for name in table_names}
    device = next(iter(params.values())).device
    return {"moments": moments, "step": 0, "dropped": torch.zeros((), dtype=torch.long, device=device)}


def _role_layout(model, params):
    """The model's row tables grouped by batch role for the packed layouts:
    {role: [(table name, width, ndim), ...]} in ``row_tables()`` order; 1-D
    bias tables get width 1."""
    roles = {}
    for name, role in model.row_tables().items():
        shape = params[name].shape
        roles.setdefault(role, []).append((name, shape[1] if len(shape) == 2 else 1, len(shape)))
    return roles


def compact_capacity_estimate(users, items, batch_size):
    """The JAX package's default capacity of the "compact" layout, draw for
    draw: the largest share of unique ids over 4 sampled batches (users,
    positives and uniform negatives; ``np.random.default_rng(0)``) x 1.25 of
    the step's 3B ids, rounded up to 8 and at most 3B."""
    rng = np.random.default_rng(0)
    users, items = np.asarray(users), np.asarray(items)
    n = len(users)
    n_items = int(items.max()) + 1 if len(items) else 1
    fracs = []
    for _ in range(4):
        sel = rng.integers(0, n, batch_size)
        ids = np.concatenate([
            users[sel].astype(np.int64),
            items[sel].astype(np.int64) + (1 << 32),
            rng.integers(0, n_items, batch_size) + (1 << 32),
        ])
        fracs.append(len(np.unique(ids)) / len(ids))
    est = max(fracs) * 1.25
    return min(-(-int(3 * batch_size * est) // 8) * 8, 3 * batch_size)


def compact_rows(ids_s, g_d, capacity):
    """The "compact" layout's capacity C on a step's sorted packed ids and
    their deduplicated gradient rows: the first C unique ids keep their
    gradient, the others' rows are zeroed (the lazy rule then skips them).
    Returns (the gradient rows, the unique ids dropped as a 0-d tensor)."""
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(first, 0) - 1
    dropped = (seg[-1] + 1 - capacity).clamp(min=0)
    return torch.where((seg < capacity)[:, None], g_d, 0.0), dropped


class PackedRows:
    """Where each row table lies in a packed array: roles (``_role_layout``)
    stacked at row offsets ``base``, a role's tables side by side from column
    0, ``w`` (w_max) the widest role. ``rects`` lists each table's rectangle
    (row0, n_rows, col0, width), the kernel's tables, in order."""

    def __init__(self, roles, role_rows):
        self.roles, self.order = roles, list(roles)
        self.rows = {role: role_rows[role] for role in roles}
        self.w = max(sum(w for _, w, _ in specs) for specs in roles.values())
        self.base, total = {}, 0
        for role in self.order:
            self.base[role] = total
            total += self.rows[role]
        self.total_rows = total
        self.columns = []  # (name, ndim, row0, n_rows, col0, width)
        for role in self.order:
            off = 0
            for name, w, nd in roles[role]:
                self.columns.append((name, nd, self.base[role], self.rows[role], off, w))
                off += w
        self.rects = [(row0, n, col0, w) for _, _, row0, n, col0, w in self.columns]

    def ids(self, role_ids):
        """(packed ids (L,), [(role, start, end)]): each role's batch ids at
        its row offset, concatenated in role order."""
        parts, segments, start = [], [], 0
        for role in self.order:
            parts.append(role_ids[role] + self.base[role])
            segments.append((role, start, start + role_ids[role].shape[0]))
            start += role_ids[role].shape[0]
        return torch.cat(parts), segments

    def rows_of(self, prow, segments):
        """{table name: its gathered rows}: slices of the (L, w) parameter
        columns ``prow`` (1-D tables as vectors)."""
        rows = {}
        for role, a, b in segments:
            off = 0
            for name, w, nd in self.roles[role]:
                part = prow[a:b, off:off + w]
                rows[name] = part[:, 0] if nd == 1 else part
                off += w
        return rows

    def _blocks(self, parts):
        for name, nd, row0, n, col0, w in self.columns:
            for c in range(parts):
                yield name, nd, c, slice(row0, row0 + n), slice(c * self.w + col0, c * self.w + col0 + w)

    def pack(self, params, moments):
        """One (total_rows, 3w) float32 [param|m|v] array of every table."""
        device = next(iter(params.values())).device
        packed = torch.zeros((self.total_rows, 3 * self.w), dtype=torch.float32, device=device)
        for name, nd, c, rows, cols in self._blocks(3):
            src = (params[name], *moments[name])[c]
            packed[rows, cols] = src[:, None] if nd == 1 else src
        return packed

    def unpack(self, packed, params, moments):
        """Copy the packed tables and moments back into ``params`` and
        ``moments`` (in place)."""
        for name, _, c, rows, cols in self._blocks(3):
            dst = (params[name], *moments[name])[c]
            dst.copy_(packed[rows, cols].reshape(dst.shape))

    def pack16(self, params, moments):
        """One (total_rows, 4w) int16 [p_hi|p_lo|m_bf16|v_bf16] array of the
        (2-D) tables."""
        device = next(iter(params.values())).device
        packed = torch.zeros((self.total_rows, 4 * self.w), dtype=torch.int16, device=device)
        for name, _, row0, n, col0, w in self.columns:
            comps = repack16(params[name], *moments[name])
            for c in range(4):
                packed[row0:row0 + n, c * self.w + col0:c * self.w + col0 + w] = comps[:, c * w:(c + 1) * w]
        return packed

    def unpack16(self, packed, params, moments):
        """Copy the packed tables (exact) and moments (bfloat16 values) back
        into ``params`` and ``moments`` (in place)."""
        for role in self.order:
            b0 = self.base[role]
            p, m, v = unpack16_components(packed[b0:b0 + self.rows[role]], self.w)
            off = 0
            for name, w, _ in self.roles[role]:
                for dst, src in zip((params[name], *moments[name]), (p, m, v)):
                    dst.copy_(src[:, off:off + w])
                off += w


class SparseEpochTrainer(EpochBatches):
    """Whole-epoch trainer with lazy-Adam row updates of the model's row
    tables (``model.row_tables()``, ``model.row_loss``); the other
    parameters (MF's ``global_bias``) update through ``dense_optimizer``.

    ``run(generator)`` forms the epoch's batches and trains on them;
    ``run_batches(users, pos, neg)`` trains on given (num_batches, B) arrays.
    Both return the mean batch loss as a 0-d device tensor. Under a packed
    layout each of them (or a ``step`` called alone) packs the tables at its
    start and unpacks them at its end, so between epochs the model and
    ``state`` hold the tables as under "xla".
    """

    def __init__(self, model, train_arrays, batch_size, neg_sampler, lr, dense_optimizer, row_update="auto",
                 compute_dtype=None, compact_capacity=None):
        device = next(model.parameters()).device
        super().__init__(train_arrays, batch_size, neg_sampler, device)
        if row_update == "auto":
            row_update = "fused" if device.type == "cuda" else "xla"
        if row_update not in ROW_UPDATES:
            raise ValueError(f"unknown row_update {row_update!r}; use one of {ROW_UPDATES} or 'auto'")
        self.model = model
        self.row_loss = row_loss_with_dtype(model, compute_dtype)
        self.lr = float(lr)
        self.row_update = row_update
        self.table_roles = model.row_tables()
        params = dict(model.named_parameters())
        self.tables = {name: params[name] for name in self.table_roles}
        self.dense = {name: p for name, p in params.items() if name not in self.table_roles}
        self.dense_optimizer = dense_optimizer
        self.state = init_sparse_state({k: p.detach() for k, p in self.tables.items()}, self.tables)
        # The 2-D tables that the kernel updates, one launch a step for all.
        self.fused = [name for name, table in self.tables.items() if row_update == "fused" and table.dim() == 2]
        self.row_adam = RowAdamTables(
            [(self.tables[name].data, *self.state["moments"][name]) for name in self.fused]
        ) if self.fused else None
        self.layout = self._packed_layout() if row_update in PACKED_LAYOUTS else None
        self.bf16 = row_update == "unified_bf16" and self.layout is not None
        if row_update == "compact" and compact_capacity is None:
            compact_capacity = compact_capacity_estimate(train_arrays.users, train_arrays.items, self.batch_size)
        self.compact_capacity = compact_capacity if row_update == "compact" else None
        self._packed = self._write = None

    def _packed_layout(self):
        """The ``PackedRows`` of the packed layouts (2-D tables alone under
        "unified_bf16"; None there if the model has none, and every table
        takes ``sparse_adam_row_update``, as in the JAX package)."""
        roles = _role_layout(self.model, self.tables)
        role_rows = {}
        for role, specs in roles.items():
            heights = {self.tables[name].shape[0] for name, _, _ in specs}
            if len(heights) != 1:
                raise ValueError(f"tables of role {role!r} must share a row count, got {heights}")
            role_rows[role] = heights.pop()
        if self.row_update == "unified_bf16":
            roles = {role: [s for s in specs if s[2] == 2] for role, specs in roles.items()}
            roles = {role: specs for role, specs in roles.items() if specs}
            if not roles:
                return None
        return PackedRows(roles, role_rows)

    @property
    def dropped(self):
        return self.state["dropped"]

    @contextlib.contextmanager
    def _packed_epoch(self):
        """Pack the tables and their moments for the steps inside, unpack them
        after (nothing to do under "fused", "xla" or when already packed).
        While packed, the packed array is the only copy: the packed tables'
        and moments' own storage is released and allocated again to unpack
        into, so the optimizer state takes the packed layout's bytes."""
        if self.layout is None or self._packed is not None:
            yield
            return
        params = {name: t.data for name, t in self.tables.items()}
        moments = self.state["moments"]
        with torch.no_grad():
            self._packed = (self.layout.pack16 if self.bf16 else self.layout.pack)(params, moments)
        self._write = RowAdamPacked(self._packed, self.layout.rects, bf16=self.bf16)
        held = [t for name, *_ in self.layout.columns for t in (params[name], *moments[name])]
        held = [(t.untyped_storage(), t.untyped_storage().nbytes()) for t in held if t.untyped_storage().resizable()]
        for storage, _ in held:
            storage.resize_(0)
        try:
            yield
        finally:
            for storage, nbytes in held:
                storage.resize_(nbytes)
            with torch.no_grad():
                (self.layout.unpack16 if self.bf16 else self.layout.unpack)(self._packed, params, moments)
            self._packed = self._write = None

    def run_batches(self, users, pos, neg, generator=None):
        with self._packed_epoch():
            return super().run_batches(users, pos, neg, generator)

    def step(self, users, pos, neg, generator=None):
        """One batch: returns its loss as a 0-d device tensor (MF's row loss
        draws no dropout, so ``generator`` is unused)."""
        batch = {"users": users, "pos_items": pos, "neg_items": neg}
        role_ids = {"users": users, "items_cat": torch.cat([pos, neg])}
        if self.layout is not None:
            with self._packed_epoch():
                return self._packed_step(batch, role_ids)
        # Gradients with respect to fresh leaves of the gathered rows, never
        # the tables: nothing table-sized is formed.
        rows = {
            name: table.detach()[role_ids[self.table_roles[name]]].requires_grad_()
            for name, table in self.tables.items()
        }
        loss = self.row_loss(rows, self.dense, batch)
        grads = torch.autograd.grad(loss, [*rows.values(), *self.dense.values()])
        g_rows = dict(zip(rows, grads))
        self.state["step"] += 1
        step = self.state["step"]
        with torch.no_grad():
            for name, table in self.tables.items():
                if name not in self.fused:
                    m, v = self.state["moments"][name]
                    sparse_adam_row_update(table.data, m, v, role_ids[self.table_roles[name]], g_rows[name],
                                           self.lr, step)
            if self.row_adam is not None:
                deduped = [_segment_dedup(role_ids[self.table_roles[name]], g_rows[name]) for name in self.fused]
                self.row_adam([ids for ids, _ in deduped], [g for _, g in deduped], bias_corrections(step), self.lr)
        self._dense_step(grads[len(rows):])
        return loss.detach()

    def _packed_step(self, batch, role_ids):
        """A step of a packed layout: one gather of the packed ids' parameter
        columns, autograd with respect to that one (L, w_max) leaf, one
        shared sort and dedup, one packed write (and, under "unified_bf16",
        the bias tables' own lazy-Adam updates)."""
        lay = self.layout
        ids, segments = lay.ids(role_ids)
        with torch.no_grad():
            prow = (unpack16_components(self._packed[ids], lay.w)[0] if self.bf16
                    else self._packed[:, :lay.w][ids])
        prow.requires_grad_()
        bias = {name: table.detach()[role_ids[self.table_roles[name]]].requires_grad_()
                for name, table in self.tables.items() if self.bf16 and table.dim() == 1}
        loss = self.row_loss({**lay.rows_of(prow, segments), **bias}, self.dense, batch)
        grads = torch.autograd.grad(loss, [prow, *bias.values(), *self.dense.values()])
        self.state["step"] += 1
        step = self.state["step"]
        with torch.no_grad():
            ids_s, g_d = _segment_dedup(ids, grads[0])
            if self.compact_capacity is not None:
                g_d, dropped = compact_rows(ids_s, g_d, self.compact_capacity)
                self.state["dropped"] += dropped
            self._write(ids_s, g_d, bias_denominators(step), self.lr)
            for name, g in zip(bias, grads[1:]):
                m, v = self.state["moments"][name]
                sparse_adam_row_update(self.tables[name].data, m, v, role_ids[self.table_roles[name]], g, self.lr,
                                       step)
        self._dense_step(grads[1 + len(bias):])
        return loss.detach()


    def _dense_step(self, grads):
        for p, g in zip(self.dense.values(), grads):
            p.grad = g
        self.dense_optimizer.step()

    @torch.no_grad()
    def load_state(self, moments, step, dropped=0):
        """Set the tables' moments from ``{name: (m, v)}`` (rows past the
        table's own, a sharded run's padding, are cut), the global step and
        the dropped count."""
        self.state["step"] = int(step)
        self.state["dropped"].fill_(int(dropped))
        for name, (m, v) in self.state["moments"].items():
            m.copy_(moments[name][0][: m.shape[0]])
            v.copy_(moments[name][1][: v.shape[0]])


# ---------------------------------------------------------------------------
# Several devices: row-sharded tables and lazy-Adam shard updates
# ---------------------------------------------------------------------------


def shard_sparse_params(params, table_names, mesh):
    """{name: shards[d][m]} for the row tables of ``params``: padded to the
    model axis and row-sharded, replicated over "data" (``shard_table``).
    The other parameters stay on the model, replica (0, 0) of the mesh."""
    return {name: shard_table(params[name].detach(), mesh) for name in table_names}


def _bucket_by_owner(ids, rows, n_model, rows_per, capacity, shard_idx):
    """Compact the rows of ``ids`` owned by model shard ``shard_idx`` into a
    fixed-capacity bucket: (local row ids (C,), rows (C, d), dropped). Empty
    slots carry zero rows, which the lazy-Adam update skips. More than C owned
    rows with a gradient drop the rest; ``dropped`` (a 0-d tensor) counts
    them, so the loss is seen, never silent. Callers dedup first, so C bounds
    the UNIQUE owned ids."""
    loc = ids - shard_idx * rows_per
    mine = (loc >= 0) & (loc < rows_per) & (rows != 0).any(dim=1)
    slot = torch.cumsum(mine, 0) - 1
    write = torch.where(mine & (slot < capacity), slot, capacity)  # slot `capacity` is cut off
    buf_ids = ids.new_zeros(capacity + 1).index_put_((write,), loc.clamp(0, rows_per - 1))
    buf_rows = rows.new_zeros((capacity + 1, rows.shape[1])).index_put_(
        (write,), torch.where(mine[:, None], rows, 0.0))
    dropped = (mine.sum() - capacity).clamp(min=0)
    return buf_ids[:capacity], buf_rows[:capacity], dropped


class ShardedSparseEpochTrainer(EpochBatches):
    """Whole-epoch lazy-Adam trainer on a ("data", "model") mesh, the
    counterpart of ``make_sharded_sparse_epoch_fn``. The row tables and their
    moments are padded to the model axis and row-sharded over it (replicated
    over "data"); each batch splits over "data". A step runs each shard's part
    on its device, as ``shard_map`` runs its body:

      forward  - ``lookup_strategy`` "psum" (each shard keeps its owned rows,
                 one psum over "model") or "ring" (owned rows bucketed with
                 capacity C = ceil(B_local / n_model) * capacity_factor,
                 8-aligned, gathered by the ring all-gather kernel; 2-D tables
                 only, the 1-D bias tables take the psum). A bucket holds
                 batch positions, so a shard that owns more than C of them
                 serves the rest as zero rows, as in the JAX package;
                 ``lookup_overflow`` counts those positions;
      backward - gradients with respect to the gathered rows, local means
                 rescaled by 1/n_data; then ``grad_exchange`` "allgather"
                 (every data shard's ids and gradient rows over "data", exact)
                 or "bucketed" (dedup, keep this model shard's rows in a
                 bucket of C, all-gather the buckets; unique owned ids beyond
                 C drop their gradient, counted in ``dropped``);
      update   - ``sparse_adam_row_update`` of each owned row (the segment
                 dedup sums duplicates across data shards), and the dense
                 parameters (MF's ``global_bias``) through one
                 ``dense_optimizer(params)`` per replica, updated identically
                 from the psum-averaged gradient.

    The model must live on the mesh's first device; its own dense parameters
    are replica (0, 0), and ``assemble()`` copies the tables' real rows into
    it. ``run(generator)`` / ``run_batches(users, pos, neg)`` as in
    ``SparseEpochTrainer``. Collectives add in rank order, so a seed repeats
    bit for bit.
    """

    def __init__(self, model, train_arrays, batch_size, neg_sampler, lr, mesh, dense_optimizer,
                 lookup_strategy="psum", grad_exchange="allgather", capacity_factor=2.0, compute_dtype=None):
        if lookup_strategy not in ("psum", "ring"):
            raise ValueError(f"unknown lookup_strategy {lookup_strategy!r}; use 'psum' or 'ring'")
        if grad_exchange not in ("allgather", "bucketed"):
            raise ValueError(f"unknown grad_exchange {grad_exchange!r}; use 'allgather' or 'bucketed'")
        device = mesh.devices[0][0]
        if next(model.parameters()).device != device:
            raise ValueError(f"the model lives on {next(model.parameters()).device}, the mesh starts at {device}")
        self.n_data, self.n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
        super().__init__(train_arrays, batch_size, neg_sampler, device)
        # Whole batches that split evenly over "data".
        self.batch_size = max(min(int(batch_size), self.n) // self.n_data, 1) * self.n_data
        self.num_batches = -(-self.n // self.batch_size)
        self.padded_size = self.num_batches * self.batch_size
        self.model, self.mesh, self.lr = model, mesh, float(lr)
        self.row_loss = row_loss_with_dtype(model, compute_dtype)
        self.lookup_strategy, self.grad_exchange = lookup_strategy, grad_exchange
        self.capacity_factor = float(capacity_factor)
        self.table_roles = model.row_tables()
        params = dict(model.named_parameters())
        self.n_rows = {name: params[name].shape[0] for name in self.table_roles}
        self.tables = shard_sparse_params(params, self.table_roles, mesh)
        self.moments = {
            name: [[(torch.zeros_like(t), torch.zeros_like(t)) for t in row] for row in shards]
            for name, shards in self.tables.items()
        }
        dense = {k: p for k, p in params.items() if k not in self.table_roles}
        self.dense = [
            [{k: p if (d, m) == (0, 0) else torch.nn.Parameter(p.detach().to(device_, copy=True))
              for k, p in dense.items()} for m, device_ in enumerate(row)]
            for d, row in enumerate(mesh.devices)
        ]
        self.dense_optimizers = [[dense_optimizer(list(p.values())) for p in row] for row in self.dense]
        self.step_count = 0
        self.dropped = torch.zeros((), dtype=torch.long, device=device)
        self.lookup_overflow = torch.zeros((), dtype=torch.long, device=device)

    def _capacity_for(self, n_ids):
        cap = max(int(-(-n_ids // self.n_model) * self.capacity_factor), 1)
        return -(-cap // 8) * 8  # 8-row blocks for the ring, as the JAX package aligns them

    def _gather(self, local_tables, ids, overflows):
        if self.lookup_strategy == "ring" and local_tables[0].dim() == 2 and self.n_model > 1:
            capacity = self._capacity_for(ids[0].shape[0])
            owners = torch.bincount(ids[0] // local_tables[0].shape[0], minlength=self.n_model)
            overflows.append((owners - capacity).clamp(min=0).sum())
            return local_ring_gather(local_tables, ids, self.n_model, capacity)
        return local_psum_gather(local_tables, ids)

    def step(self, users, pos, neg, generator=None):
        """One batch: returns its loss (the global batch mean) as a 0-d tensor
        on the mesh's first device (``generator`` is unused, as in
        ``SparseEpochTrainer.step``)."""
        devices, n_data, n_model = self.mesh.devices, self.n_data, self.n_model
        b_local = users.shape[0] // n_data
        batch, role_ids = [], []
        for d, row in enumerate(devices):
            u, p, ng = (x[d * b_local:(d + 1) * b_local] for x in (users, pos, neg))
            batch.append([{"users": u.to(dev), "pos_items": p.to(dev), "neg_items": ng.to(dev)} for dev in row])
            role_ids.append([{"users": bt["users"], "items_cat": torch.cat([bt["pos_items"], bt["neg_items"]])}
                             for bt in batch[d]])
        ids = {name: [[r[role] for r in row] for row in role_ids] for name, role in self.table_roles.items()}
        overflows = []
        rows = {name: [self._gather(shards[d], ids[name][d], overflows) for d in range(n_data)]
                for name, shards in self.tables.items()}
        # Loss and gradients on every shard, with respect to fresh leaves of
        # the gathered rows: nothing table-sized is formed.
        losses = [[None] * n_model for _ in range(n_data)]
        g_rows = {name: [[None] * n_model for _ in range(n_data)] for name in self.tables}
        g_dense = [[None] * n_model for _ in range(n_data)]
        for d in range(n_data):
            for m in range(n_model):
                leaves = {name: rows[name][d][m].detach().requires_grad_() for name in self.tables}
                dense = self.dense[d][m]
                loss = self.row_loss(leaves, dense, batch[d][m])
                grads = torch.autograd.grad(loss, [*leaves.values(), *dense.values()])
                losses[d][m] = loss.detach()
                for name, g in zip(leaves, grads):
                    g_rows[name][d][m] = g
                g_dense[d][m] = grads[len(leaves):]
        self.step_count += 1
        drops = []
        with torch.no_grad():
            for name in self.tables:
                for m in range(n_model):
                    safe, g_masked = self._exchange(name, m, [ids[name][d][m] for d in range(n_data)],
                                                    [g_rows[name][d][m] / n_data for d in range(n_data)], drops)
                    for d in range(n_data):
                        m_, v_ = self.moments[name][d][m]
                        sparse_adam_row_update(self.tables[name][d][m], m_, v_, safe[d], g_masked[d], self.lr,
                                               self.step_count)
        # Local means -> the global batch mean: psum over "data" / n_data.
        for m in range(n_model):
            summed = [psum([g_dense[d][m][k] for d in range(n_data)]) for k in range(len(g_dense[0][m]))]
            for d in range(n_data):
                for p, g in zip(self.dense[d][m].values(), summed):
                    p.grad = g[d] / n_data
        for row in self.dense_optimizers:
            for opt in row:
                opt.step()
        for total, counts in ((self.dropped, drops), (self.lookup_overflow, overflows)):
            if counts:
                total += torch.stack([x.to(self.device) for x in counts]).sum()
        return psum([losses[d][0] for d in range(n_data)])[0] / n_data

    def _exchange(self, name, m, ids_local, g_local, drops):
        """Model shard m's (ids, gradient rows) for its update on every data
        shard, over "data": (list of local row ids, list of rows), one each."""
        rows_per = self.tables[name][0][m].shape[0]
        if self.grad_exchange == "bucketed":
            one_d = g_local[0].dim() == 1
            cap = self._capacity_for(ids_local[0].shape[0])
            b_ids, b_rows = [], []
            for i, g in zip(ids_local, g_local):
                ids_d, g_d = _segment_dedup(i, g[:, None] if one_d else g)
                bi, br, dropped = _bucket_by_owner(ids_d, g_d, self.n_model, rows_per, cap, m)
                b_ids.append(bi)
                b_rows.append(br)
                drops.append(dropped)
            safe, g_all = all_gather(b_ids), all_gather(b_rows)
            return safe, [g[:, 0] for g in g_all] if one_d else g_all
        safe, g_masked = [], []
        for ids_all, g_all in zip(all_gather(ids_local), all_gather(g_local)):
            loc = ids_all - m * rows_per
            ok = (loc >= 0) & (loc < rows_per)
            mask = ok[:, None] if g_all.dim() > 1 else ok
            safe.append(loc.clamp(0, rows_per - 1))
            g_masked.append(torch.where(mask, g_all, 0.0))
        return safe, g_masked

    # -- the whole tables, on the mesh's first device ---------------------------

    def _full(self, shards):
        return torch.cat([s.to(self.device) for s in shards[0]])

    @property
    def state(self):
        """{"moments": {name: (m, v)} padded, "step", "dropped"}: the layout of
        ``SparseEpochTrainer.state`` for the checkpoint."""
        moments = {name: tuple(self._full([[mv[i] for mv in row] for row in shards]) for i in (0, 1))
                   for name, shards in self.moments.items()}
        return {"moments": moments, "step": self.step_count, "dropped": self.dropped}

    def padded_params(self):
        """{name: tensor} of every parameter: row tables padded, as the JAX
        package's sharded run holds (and checkpoints) them."""
        return {name: self._full(self.tables[name]) if name in self.tables else p.detach()
                for name, p in self.model.named_parameters()}

    @torch.no_grad()
    def place(self):
        """Shard the model's current tables again (padded to the model axis,
        as ``shard_sparse_params`` places them) and copy its dense
        parameters into every replica: the JAX ``_replace_on_mesh``."""
        params = dict(self.model.named_parameters())
        for name, shards in self.tables.items():
            for row, placed in zip(shards, shard_table(params[name].detach(), self.mesh)):
                for shard, part in zip(row, placed):
                    shard.copy_(part)
        for row in self.dense:
            for replica in row:
                for name, p in replica.items():
                    if p is not params[name]:
                        p.copy_(params[name])

    @torch.no_grad()
    def load_state(self, moments, step, dropped=0):
        """Set the tables' moments from ``{name: (m, v)}``, whole tables,
        padded or not, row-sharded as the tables are, the global step and the
        dropped count."""
        self.step_count = int(step)
        self.dropped.fill_(int(dropped))
        for name, shards in self.moments.items():
            for i in (0, 1):
                placed = shard_table(moments[name][i][: self.tables[name][0][0].shape[0] * self.n_model], self.mesh)
                for row, parts in zip(shards, placed):
                    for mv, part in zip(row, parts):
                        mv[i].copy_(part)

    @torch.no_grad()
    def assemble(self):
        """Copy the tables' real rows into the model (its dense parameters are
        replica (0, 0) already): the model then scores as the mesh holds it."""
        params = dict(self.model.named_parameters())
        for name, shards in self.tables.items():
            params[name].copy_(self._full(shards)[: self.n_rows[name]])
