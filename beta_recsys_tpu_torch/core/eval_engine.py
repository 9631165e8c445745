"""Ranked evaluation over fixed candidate sets or the full catalog,
early-stop bookkeeping and the final-test record.

Counterpart of ``RankingEvaluator``, ``FullCatalogEvaluator``,
``TopKRetrievalEvaluator``, ``EvalBookkeeper`` and ``test_eval`` in
``beta_recsys_tpu/core/eval_engine.py``. ``RankingEvaluator`` scores every
user's candidate set and reduces every metric@k on the model's device in
one call; the metric values reach the host in one transfer. The two
full-catalog evaluators score users in blocks against every item; each
block's relevance and exclusion masks are built on the device from index
arrays cached at construction. The JAX package pads every block to one
shape so XLA compiles once; PyTorch has no such need, so the last block is
simply shorter. Evaluators score with the model's current parameters.

With a ``mesh``, ``RankingEvaluator`` and ``FullCatalogEvaluator`` split their
user rows over its "data" axis: data shard d scores its rows on
``mesh.devices[d][0]`` (the model there, or its replica, synced before each
evaluation; ``replicas`` hands in ones that already exist, as the trainer's),
and the shards' metric sums (float64) are added in rank order (one ``psum``),
then divided by the real users, as the JAX package's sharded means are
rescaled by padded/real. Without a mesh the model's device is the one shard:
a float32 mean times at most 2^24 rows and divided again is the same mean.
"""

import contextlib
import csv
import os
import time

import numpy as np
import torch

from ..ops.metrics import metrics_from_top, ranking_metrics
from ..ops.topk import NEG_INF, exclusion_lists, retrieval_topk, streaming_topk
from ..parallel.collectives import psum
from ..parallel.data_parallel import Replicas
from ..parallel.mesh import DATA_AXIS
from ..utils.common import save_to_csv
from ..utils.constants import MAX_N_UPDATE

DEFAULT_METRICS = ("ndcg", "precision", "recall", "map")

# The fast retrieval route's bound on k + the largest train degree, as in the
# JAX package: beyond it the streaming route with an exclusion mask.
FAST_RETRIEVAL_WIDTH = 256


def _data_devices(mesh):
    """Each data shard's device: the first of its row."""
    return [row[0] for row in mesh.devices]


def _metric_sum(out, n):
    """A shard's metric means times its rows: its per-user sums, float64."""
    return torch.stack(list(out.values())).double() * n


def _sum_in_rank_order(parts):
    """The shards' metric-sum vectors added in rank order (one psum), on the
    host."""
    return psum(parts)[0].cpu().tolist()


def _replicas(model, devices, replicas):
    """``replicas`` (the model on each of ``devices``), built when None."""
    return Replicas(model, devices) if replicas is None else replicas


class RankingEvaluator:
    """Evaluation over fixed candidate sets (1 positive + n negatives).

    With ``mesh`` the user rows are padded to a multiple of the data-axis
    size by repeating the last row with empty masks and zero relevance, as
    the JAX package pads them (the padded rows stay in ``users``, ``items``,
    ``relevance`` and ``mask``; ``write_per_user`` drops them with their
    masks), and each data shard scores its slice."""

    def __init__(self, model, candidates, metrics=("ndcg", "precision", "recall", "map"), ks=(5, 10, 20),
                 mesh=None, replicas=None):
        self.model = model
        self.metrics = tuple(metrics)
        self.ks = tuple(int(k) for k in ks)
        self.mesh = mesh
        users, items = np.asarray(candidates.users), np.asarray(candidates.items)
        relevance, mask = np.asarray(candidates.relevance), np.asarray(candidates.mask)
        self.n_real = users.shape[0]
        devices = [model.device] if mesh is None or not self.n_real else _data_devices(mesh)
        pad = (-self.n_real) % len(devices)
        if pad:
            users = np.concatenate([users, np.repeat(users[-1:], pad, axis=0)])
            items = np.concatenate([items, np.repeat(items[-1:], pad, axis=0)])
            relevance = np.concatenate([relevance, np.zeros((pad, *relevance.shape[1:]), relevance.dtype)])
            mask = np.concatenate([mask, np.zeros((pad, *mask.shape[1:]), mask.dtype)])
        device = model.device
        self.users = torch.as_tensor(users, dtype=torch.long, device=device)
        self.items = torch.as_tensor(items, dtype=torch.long, device=device)
        self.relevance = torch.as_tensor(relevance, device=device)
        self.mask = torch.as_tensor(mask, device=device)
        self.replicas = _replicas(model, devices, replicas)
        rows = users.shape[0] // len(devices)
        self.shards = [(dev, *(x[d * rows:(d + 1) * rows].to(dev) for x in (self.users, self.items,
                                                                          self.relevance, self.mask)))
                       for d, dev in enumerate(devices)]

    @torch.no_grad()
    def evaluate(self):
        """{metric@k: float} for the model's current parameters."""
        self.replicas.sync()
        sums = []
        for device, users, items, relevance, mask in self.shards:
            scores = self.replicas[device].score_candidates(users, items)
            out = ranking_metrics(scores, relevance, mask, self.metrics, self.ks)
            sums.append(_metric_sum(out, users.shape[0]))
        return {key: value / max(self.n_real, 1) for key, value in zip(out, _sum_in_rank_order(sums))}


def _canonical(csr):
    """A CSR copy with duplicate entries summed, as ``todense()`` sums them."""
    csr = csr.tocsr(copy=True)
    csr.sum_duplicates()
    return csr


def _coo_on(csr, rows, device):
    """(row, col, value) tensors of ``csr[rows]`` on ``device``."""
    sub = csr[rows].tocoo()
    return (torch.as_tensor(sub.row, dtype=torch.long, device=device),
            torch.as_tensor(sub.col, dtype=torch.long, device=device),
            torch.as_tensor(sub.data, dtype=torch.float32, device=device))


def _dense(coo, n_rows, n_cols, device):
    rows, cols, vals = coo
    return torch.zeros((n_rows, n_cols), dtype=torch.float32, device=device).index_put_((rows, cols), vals)


class FullCatalogEvaluator:
    """Full-catalog ranked evaluation: each user's scores over every item,
    train positives (summed train rating > 0) set to ``NEG_INF``, then the
    candidate metrics with every item a candidate. ``users`` are dense user
    ids; ``relevance_csr`` and ``train_csr`` are (n_users, n_items) scipy
    sparse matrices whose duplicate entries are summed. ``evaluate()``
    returns the mean of every metric@k over the users ({} for none), keys
    sorted as the JAX package's ``device_get`` of a dict returns them.

    With ``mesh``, ``user_block`` is rounded down to a multiple of the data
    axis and each block's rows split over it (the last, shorter block as
    evenly as it goes)."""

    def __init__(self, model, users, relevance_csr, train_csr, metrics=DEFAULT_METRICS, ks=(5, 10, 20),
                 user_block=1024, mesh=None, replicas=None):
        self.model = model
        self.metrics = tuple(metrics)
        self.ks = tuple(int(k) for k in ks)
        self.mesh = mesh
        devices = [model.device] if mesh is None else _data_devices(mesh)
        self.user_block = max(int(user_block) // len(devices), 1) * len(devices)
        self.users = np.asarray(users, dtype=np.int64)
        relevance_csr, train_csr = _canonical(relevance_csr), _canonical(train_csr)
        self.replicas = _replicas(model, devices, replicas)
        self._blocks = []  # a block: one (device, users, relevance COO, train COO) a data shard
        for start in range(0, len(self.users), self.user_block):
            parts = np.array_split(self.users[start:start + self.user_block], len(devices))
            self._blocks.append([(dev, torch.as_tensor(blk, device=dev), _coo_on(relevance_csr, blk, dev),
                                  _coo_on(train_csr, blk, dev)) for dev, blk in zip(devices, parts) if len(blk)])

    @torch.no_grad()
    def evaluate(self):
        n_items = self.model.n_items
        self.replicas.sync()
        totals, keys = None, None
        with contextlib.ExitStack() as held:
            for model in self.replicas.by_device.values():
                held.enter_context(model.holding_embeddings())
            for shards in self._blocks:
                sums = []
                for device, users, rel_coo, trn_coo in shards:
                    model = self.replicas[device]
                    n = users.shape[0]
                    relevance = _dense(rel_coo, n, n_items, device)
                    seen = _dense(trn_coo, n, n_items, device) > 0
                    scores = model.score_all(users)[:, :n_items].masked_fill(seen, NEG_INF)
                    out = ranking_metrics(scores, relevance, torch.ones_like(seen), self.metrics, self.ks)
                    keys = list(out)
                    sums.append(_metric_sum(out, n))
                block = _sum_in_rank_order(sums)
                totals = block if totals is None else [t + b for t, b in zip(totals, block)]
        if totals is None:
            return {}
        n = max(len(self.users), 1)
        return {key: value / n for key, value in sorted(zip(keys, totals))}


class TopKRetrievalEvaluator:
    """Full-catalog ranked evaluation of a factorized model through top-k
    retrieval: per user block, the ``max(ks)`` best items with every stored
    train entry excluded, then the metrics on the device from those items'
    relevance and each user's relevant count (``metrics_from_top``, the
    formulas of the JAX package's host code), each block's means weighted
    by its rows.
    While ``max(ks)`` + the users' largest train degree is at most
    ``FAST_RETRIEVAL_WIDTH``, ``retrieval_topk`` with per-user exclusion
    lists (bfloat16 scores with ``mode="approx"``); otherwise
    ``streaming_topk`` over ``item_block`` items a step with an exclusion
    mask. With no users every metric is 0, as in the JAX package."""

    def __init__(self, model, users, relevance_csr, train_csr, metrics=DEFAULT_METRICS, ks=(5, 10, 20),
                 user_block=1024, item_block=8192, mode="exact"):
        if mode not in ("exact", "approx"):
            raise ValueError(f"mode must be 'exact' or 'approx'; got {mode!r}")
        self.model = model
        self.metrics = tuple(metrics)
        self.ks = tuple(int(k) for k in ks)
        self.max_k = max(self.ks)
        self.user_block = int(user_block)
        self.item_block = int(item_block)
        self.mode = mode
        self.users = np.asarray(users, dtype=np.int64)
        relevance_csr, train_csr = _canonical(relevance_csr), _canonical(train_csr)
        degrees = np.diff(train_csr.indptr)[self.users] if len(self.users) else np.zeros(0, np.int64)
        self.max_deg = int(degrees.max()) if len(degrees) else 0
        self.use_fast = self.max_k + self.max_deg <= FAST_RETRIEVAL_WIDTH
        device = model.device
        self._blocks = []
        for start in range(0, len(self.users), self.user_block):
            blk = self.users[start:start + self.user_block]
            rel = relevance_csr[blk]
            r_deg = np.diff(rel.indptr)
            width = max(int(r_deg.max()) if len(r_deg) else 0, 1)
            # each user's relevant items padded with n_items ("none"), and their values
            rel_items = np.full((len(blk), width), model.n_items, np.int64)
            rel_vals = np.zeros((len(blk), width), np.float32)
            rows = np.repeat(np.arange(len(blk)), r_deg)
            cols = np.arange(len(rows)) - np.repeat(rel.indptr[:-1], r_deg)
            rel_items[rows, cols] = rel.indices
            rel_vals[rows, cols] = rel.data
            actual = np.asarray(rel.sum(axis=1), dtype=np.float32).flatten()
            if self.use_fast:
                exclusion = torch.as_tensor(exclusion_lists(train_csr[blk]), device=device)
            else:
                exclusion = _coo_on(train_csr, blk, device)[:2]
            self._blocks.append((torch.as_tensor(blk, device=device), exclusion,
                                 torch.as_tensor(rel_items, device=device),
                                 torch.as_tensor(rel_vals, device=device), torch.as_tensor(actual, device=device)))

    def _top_items(self, u_emb, i_emb, exclusion):
        if self.use_fast:
            _, idx = retrieval_topk(u_emb, i_emb, self.max_k, exclude_list=exclusion, mode=self.mode,
                                    score_dtype="bfloat16" if self.mode == "approx" else None)
            return idx
        rows, cols = exclusion
        mask = torch.zeros((u_emb.shape[0], i_emb.shape[0]), dtype=torch.bool, device=u_emb.device)
        mask[rows, cols] = True
        _, idx = streaming_topk(u_emb, i_emb, self.max_k, block=self.item_block, exclude_mask=mask)
        return idx

    @torch.no_grad()
    def evaluate(self):
        totals = {f"{m}@{k}": 0.0 for m in self.metrics for k in self.ks}
        u_all, i_all = self.model.user_item_embeddings_trimmed()
        for users, exclusion, rel_items, rel_vals, actual in self._blocks:
            idx = self._top_items(u_all[users], i_all, exclusion)
            hit = idx[:, :, None] == rel_items[:, None, :]
            top_rel = (hit * rel_vals[:, None, :]).sum(dim=2)
            out = metrics_from_top(top_rel, actual, self.metrics, self.ks)
            values = torch.stack(list(out.values())).cpu().tolist()
            for key, value in zip(out, values):
                totals[key] += value * users.shape[0]
        n = max(len(self.users), 1)
        return {key: value / n for key, value in totals.items()}


class EvalBookkeeper:
    """Best valid metric and early stop: training stops after
    ``max_n_update`` epochs in a row without a strict improvement."""

    def __init__(self, valid_metric="ndcg", valid_k=10, max_n_update=MAX_N_UPDATE):
        self.key = f"{valid_metric}@{valid_k}"
        self.max_n_update = max_n_update
        self.best_valid_performance = 0.0
        self.best_epoch = -1
        self.n_no_update = 0
        self.history = []

    def update(self, epoch, valid_result, test_result=None):
        """Record an epoch's results; returns True if the valid metric improved."""
        score = valid_result[self.key]
        self.history.append({"epoch": epoch, "valid": dict(valid_result), "test": dict(test_result or {})})
        if score > self.best_valid_performance:
            self.best_valid_performance = score
            self.best_epoch = epoch
            self.n_no_update = 0
            return True
        self.n_no_update += 1
        return False

    @property
    def should_stop(self):
        return self.n_no_update >= self.max_n_update


def test_eval(evaluators, result_file=None, result_para=None, run_time=None, save_mode="average",
              per_user_file=None):
    """Evaluate each of the n_test candidate copies; return the mean row and
    the per-copy rows. With ``result_file``, the mean row (metric columns in
    sorted order, then run_time, time and the ``result_para`` columns, as the
    JAX package writes them) is appended to that CSV. With ``save_mode``
    "per_user" and ``per_user_file``, the first copy's candidates are also
    written there, one row each: col_user, col_item, col_rating (the
    relevance) and col_prediction (``write_per_user``)."""
    if save_mode not in ("average", "per_user"):
        raise ValueError(f"unknown save_mode {save_mode!r}; use 'average' or 'per_user'")
    rows = [ev.evaluate() for ev in evaluators]
    mean_row = {k: float(np.mean([r[k] for r in rows])) for k in sorted(rows[0])} if rows else {}
    if result_file:
        record = dict(mean_row)
        if run_time is not None:
            record["run_time"] = run_time
        record["time"] = time.strftime("%Y-%m-%d %H:%M:%S")
        for k, v in (result_para or {}).items():
            record[k] = str(v)
        append_csv_row(record, result_file)
    if save_mode == "per_user" and evaluators and per_user_file:
        write_per_user(evaluators[0], per_user_file)
    return mean_row, rows


@torch.no_grad()
def write_per_user(evaluator, path):
    """A ``RankingEvaluator``'s scored candidates as CSV, a row per valid
    slot in user-major order, with the JAX package's header; numbers as
    pandas' ``to_csv`` writes them (shortest round-trip reprs)."""
    scores = evaluator.model.score_candidates(evaluator.users, evaluator.items)
    mask = evaluator.mask
    users = evaluator.users[:, None].expand(mask.shape)[mask].cpu().numpy()
    columns = (users, evaluator.items[mask].cpu().numpy(), evaluator.relevance[mask].cpu().numpy(),
               scores[mask].cpu().numpy())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["col_user", "col_item", "col_rating", "col_prediction"])
        writer.writerows(zip(*(col.tolist() if col.dtype.kind in "iu" else [str(v) for v in col]
                               for col in columns)))


def append_csv_row(record, result_file):
    """Append one row to a CSV, creating it with a header if absent; a column
    the file lacks is added at the end (earlier rows leave it empty)."""
    save_to_csv(record, result_file)
