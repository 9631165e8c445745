"""Sparse (lazy) Adam for embedding tables: gradients with respect to the
gathered rows, Adam moments and parameters updated only at the touched ids.

Counterpart of ``beta_recsys_tpu/core/sparse_optim.py`` (``_segment_dedup``,
``sparse_adam_row_update``, ``init_sparse_state``, ``make_sparse_epoch_fn``,
one device). Semantics are TF-style lazy Adam: the bias-correction step count
is global over the whole run, and the gradient rows of an id that occurs
several times in a batch are summed before one moment update.

``row_update`` picks how the 2-D tables' rows are written back:
  "fused" - the ``fused_rowadam`` CUDA kernel (``ops/kernels/rowadam.py``), in
    place; on CPU tensors its plain version;
  "xla"   - ``sparse_adam_row_update``: gather, torch arithmetic, index_add_;
  "auto"  - "fused" where the tables are on the card, "xla" on the CPU: as
    the JAX package takes its kernel where one exists (the TPU) and "xla"
    elsewhere.
1-D bias tables take ``sparse_adam_row_update`` under either. The JAX
package's "unified", "compact" and "unified_bf16" are TPU row layouts and
raise here. Tables and moments are updated in place.
"""

import torch

from ..ops.kernels.rowadam import adam_rows, bias_corrections, fused_rowadam
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

    def __init__(self, model, train_arrays, batch_size, neg_sampler, lr, dense_optimizer, row_update="auto"):
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
        self.lr = float(lr)
        self.row_update = row_update
        self.table_roles = model.row_tables()
        params = dict(model.named_parameters())
        self.tables = {name: params[name] for name in self.table_roles}
        self.dense = {name: p for name, p in params.items() if name not in self.table_roles}
        self.dense_optimizer = dense_optimizer
        self.state = init_sparse_state({k: p.detach() for k, p in self.tables.items()}, self.tables)

    def step(self, users, pos, neg):
        """One batch: returns its loss as a 0-d device tensor."""
        batch = {"users": users, "pos_items": pos, "neg_items": neg}
        role_ids = {"users": users, "items_cat": torch.cat([pos, neg])}
        # Gradients with respect to fresh leaves of the gathered rows, never
        # the tables: nothing table-sized is formed.
        rows = {
            name: table.detach()[role_ids[self.table_roles[name]]].requires_grad_()
            for name, table in self.tables.items()
        }
        loss = self.model.row_loss(rows, self.dense, batch)
        grads = torch.autograd.grad(loss, [*rows.values(), *self.dense.values()])
        g_rows = dict(zip(rows, grads))
        self.state["step"] += 1
        step = self.state["step"]
        with torch.no_grad():
            for name, table in self.tables.items():
                m, v = self.state["moments"][name]
                ids = role_ids[self.table_roles[name]]
                if self.row_update == "fused" and table.dim() == 2:
                    ids_s, g_d = _segment_dedup(ids, g_rows[name])
                    fused_rowadam(table.data, m, v, ids_s, g_d, bias_corrections(step), self.lr)
                else:
                    sparse_adam_row_update(table.data, m, v, ids, g_rows[name], self.lr, step)
        for p, g in zip(self.dense.values(), grads[len(rows):]):
            p.grad = g
        self.dense_optimizer.step()
        return loss.detach()
