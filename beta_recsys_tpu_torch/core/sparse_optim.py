"""Sparse (lazy) Adam for embedding tables: gradients with respect to the
gathered rows, Adam moments and parameters updated only at the touched ids.

Counterpart of ``beta_recsys_tpu/core/sparse_optim.py`` (``_segment_dedup``,
``sparse_adam_row_update``, ``init_sparse_state``, ``make_sparse_epoch_fn``,
one device). Semantics are TF-style lazy Adam: the bias-correction step count
is global over the whole run, and the gradient rows of an id that occurs
several times in a batch are summed before one moment update.

``row_update`` picks how the 2-D tables' rows are written back:
  "fused" - the ``fused_rowadam`` CUDA kernel (``ops/kernels/rowadam.py``), in
    place, one launch a step for all of them (``RowAdamTables``, its tables
    and moments checked once); on CPU tensors its plain version;
  "xla"   - ``sparse_adam_row_update``: gather, torch arithmetic, index_add_;
  "auto"  - "fused" where the tables are on the card, "xla" on the CPU: as
    the JAX package takes its kernel where one exists (the TPU) and "xla"
    elsewhere.
1-D bias tables take ``sparse_adam_row_update`` under either. The JAX
package's "unified", "compact" and "unified_bf16" are TPU row layouts and
raise here. Tables and moments are updated in place.

``ShardedSparseEpochTrainer`` is the counterpart of
``make_sharded_sparse_epoch_fn``: the same lazy Adam with tables and moments
row-sharded over a mesh's "model" axis and batches over "data".
"""

import torch

from ..ops.kernels.rowadam import RowAdamTables, adam_rows, bias_corrections
from ..parallel.collectives import all_gather, psum
from ..parallel.embedding import local_psum_gather, local_ring_gather, shard_table
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from .mixed_precision import row_loss_with_dtype
from .train_engine import EpochBatches

TPU_ROW_LAYOUTS = ("unified", "compact", "unified_bf16")


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
    """Zero Adam moments for the sparse tables and the global step count."""
    moments = {name: (torch.zeros_like(params[name]), torch.zeros_like(params[name])) for name in table_names}
    return {"moments": moments, "step": 0}


class SparseEpochTrainer(EpochBatches):
    """Whole-epoch trainer with lazy-Adam row updates of the model's row
    tables (``model.row_tables()``, ``model.row_loss``); the other
    parameters (MF's ``global_bias``) update through ``dense_optimizer``.

    ``run(generator)`` forms the epoch's batches and trains on them;
    ``run_batches(users, pos, neg)`` trains on given (num_batches, B) arrays.
    Both return the mean batch loss as a 0-d device tensor.
    """

    def __init__(self, model, train_arrays, batch_size, neg_sampler, lr, dense_optimizer, row_update="auto",
                 compute_dtype=None):
        device = next(model.parameters()).device
        super().__init__(train_arrays, batch_size, neg_sampler, device)
        if row_update == "auto":
            row_update = "fused" if device.type == "cuda" else "xla"
        if row_update in TPU_ROW_LAYOUTS:
            raise NotImplementedError(
                f"row_update={row_update!r} is a TPU row layout; whether the card wants one "
                "waits for a measurement (ROADMAP.md, section 1 item 2, the rest of MF training)"
            )
        if row_update not in ("fused", "xla"):
            raise ValueError(f"unknown row_update {row_update!r}; use 'fused', 'xla' or 'auto'")
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

    def step(self, users, pos, neg, generator=None):
        """One batch: returns its loss as a 0-d device tensor (MF's row loss
        draws no dropout, so ``generator`` is unused)."""
        batch = {"users": users, "pos_items": pos, "neg_items": neg}
        role_ids = {"users": users, "items_cat": torch.cat([pos, neg])}
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
        for p, g in zip(self.dense.values(), grads[len(rows):]):
            p.grad = g
        self.dense_optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def load_state(self, moments, step):
        """Set the tables' moments from ``{name: (m, v)}`` (rows past the
        table's own, a sharded run's padding, are cut) and the global step."""
        self.state["step"] = int(step)
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
    def load_state(self, moments, step):
        """Set the tables' moments from ``{name: (m, v)}``, whole tables,
        padded or not, row-sharded as the tables are, and the global step."""
        self.step_count = int(step)
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
