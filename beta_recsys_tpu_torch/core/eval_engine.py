"""Ranked evaluation over fixed candidate sets, early-stop bookkeeping and
the final-test record.

Counterpart of ``RankingEvaluator``, ``EvalBookkeeper`` and ``test_eval`` in
``beta_recsys_tpu/core/eval_engine.py``: one call scores every user's
candidate set and reduces every metric@k on the model's device; the metric
values reach the host in one transfer.
"""

import csv
import os
import time

import numpy as np
import torch

from ..ops.metrics import ranking_metrics
from ..utils.constants import MAX_N_UPDATE


class RankingEvaluator:
    """Evaluation over fixed candidate sets (1 positive + n negatives)."""

    def __init__(self, model, candidates, metrics=("ndcg", "precision", "recall", "map"), ks=(5, 10, 20)):
        self.model = model
        self.metrics = tuple(metrics)
        self.ks = tuple(int(k) for k in ks)
        device = model.device
        self.users = torch.as_tensor(candidates.users, dtype=torch.long, device=device)
        self.items = torch.as_tensor(candidates.items, dtype=torch.long, device=device)
        self.relevance = torch.as_tensor(candidates.relevance, device=device)
        self.mask = torch.as_tensor(candidates.mask, device=device)

    @torch.no_grad()
    def evaluate(self):
        """{metric@k: float} for the model's current parameters."""
        scores = self.model.score_candidates(self.users, self.items)
        out = ranking_metrics(scores, self.relevance, self.mask, self.metrics, self.ks)
        values = torch.stack(list(out.values())).cpu().tolist()
        return dict(zip(out, values))


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


def test_eval(evaluators, result_file=None, result_para=None, run_time=None):
    """Evaluate each of the n_test candidate copies; return the mean row and
    the per-copy rows. With ``result_file``, the mean row (metric columns in
    sorted order, then run_time, time and the ``result_para`` columns, as the
    JAX package writes them) is appended to that CSV."""
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
    return mean_row, rows


def append_csv_row(record, result_file):
    """Append one row to a CSV, creating it with a header if absent; a column
    the file lacks is added at the end (earlier rows leave it empty)."""
    os.makedirs(os.path.dirname(result_file) or ".", exist_ok=True)
    prior, fields = [], []
    if os.path.exists(result_file):
        with open(result_file, newline="") as f:
            reader = csv.DictReader(f)
            fields = list(reader.fieldnames or [])
            prior = list(reader)
    fields += [k for k in record if k not in fields]
    with open(result_file, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(prior)
        writer.writerow(record)
