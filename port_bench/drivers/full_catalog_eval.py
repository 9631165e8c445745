"""Full-catalog evaluation through the port's ``FullCatalogEvaluator``
(``core/eval_engine.py``): each block of ``user_block`` users scored against
every item (the model's ``score_all``), train positives masked, one top-k at
the largest k (``ops/metrics.py``, ``ops/topk.py``), every metric@k.

Set-up makes the configuration's log and draws the weights from the seed
on the device (the item scores hold a popularity prior of
``item_prior_scale`` times each item's centred log train count, as a
trained model's do), builds the model
with its scoring inputs and one evaluator over every user, with each user's
held-out ``relevance`` item ("valid": the second newest; "test": the newest)
as relevant and the train items masked, and evaluates once: the first answer
the check compares, in which each block's scores of the held-out items are
also kept as the model's ``score_all`` hands them to the evaluator. The
window calls ``evaluate()`` back to back. Work units: users ranked.
"""

import numpy as np
import scipy.sparse as sp
import torch

from harness import data
from harness.compare import metric_gap
from harness.training import load_weights
from reference.ranking import held_out_ranks, metric_sums


def _csr(users, items, n_users, n_items):
    users, items = users.cpu().numpy(), items.cpu().numpy()
    return sp.csr_matrix((np.ones(len(users), np.float32), (users, items)), shape=(n_users, n_items))


class Driver:
    def __init__(self, cell, seed, device, fault=None):
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        self.cfg = cell.config["model"]
        self.ref = cell.reference()
        self.traffic = cell.traffic
        self.info = {"unit": "users"}
        self.passes = []
        self._undo = []

    def _weights(self):
        prior = self.cell.config["weights"]["item_prior_scale"] * (self.counts + 1.0).log()
        return self.ref.make_weights(self.cfg, self.n_users, self.n_items, data.generator(self.seed, self.device, 2),
                                     self.device, item_prior=prior - prior.mean())

    def setup(self):
        from beta_recsys_tpu_torch.core.eval_engine import FullCatalogEvaluator
        from beta_recsys_tpu_torch.models import build_model

        dev = self.device
        split = data.interactions(self.cell.config["data"], dev)
        self.n_users, self.n_items = split.n_users, split.n_items
        self.counts = split.item_counts().float()
        self.inputs = self.ref.program_inputs(self.cfg, split, dev)
        train = split.part("train")
        rel_users, self.rel_items = split.part(self.traffic["relevance"])
        self.train_keys = split.train_keys()
        train_csr = _csr(*train, self.n_users, self.n_items)
        rel_csr = _csr(rel_users, self.rel_items, self.n_users, self.n_items)
        del split, train

        self.model = build_model(self.cfg, self.n_users, self.n_items, artifacts=dict(self.inputs), device=dev)
        load_weights(self.model, self._weights())
        self._plant()
        self.evaluator = FullCatalogEvaluator(
            self.model, np.arange(self.n_users), rel_csr, train_csr, metrics=tuple(self.traffic["metrics"]),
            ks=tuple(self.traffic["ks"]), user_block=int(self.traffic["user_block"]))
        self.passes.append(self._kept_scores(self.evaluator.evaluate))
        blocks = -(-self.n_users // int(self.traffic["user_block"]))
        self.info.update(blocks_per_call=blocks, pass_flops=self.ref.score_flops(self.cfg, self.n_users, self.n_items))
        if "maxlen" in self.cfg:
            heads, d, block = int(self.cfg["num_heads"]), int(self.cfg["emb_dim"]), int(self.traffic["user_block"])
            sizes = [min(block, self.n_users - lo) for lo in range(0, self.n_users, block)]
            self.info["flash"] = [(n * heads, int(self.cfg["maxlen"]), d // heads)
                                  for n in sizes for _ in range(int(self.cfg["num_blocks"]))]

    def _kept_scores(self, evaluate):
        """``evaluate()`` with the model's ``score_all`` watched: each
        block's scores of its users' held-out items are kept."""
        score_all, kept = self.model.score_all, []

        def watched(users):
            scores = score_all(users)
            kept.append(scores.gather(1, self.rel_items[users][:, None])[:, 0])
            return scores

        self.model.score_all = watched
        try:
            out = evaluate()
        finally:
            del self.model.score_all
        self.held_out_scores = torch.cat(kept)
        return out

    def _plant(self):
        """"half_batch": each block's metrics are the mean over its first
        half of users; "altered_answer": every user's top items come in
        reverse order where the top-k is produced."""
        import beta_recsys_tpu_torch.core.eval_engine as eval_engine
        import beta_recsys_tpu_torch.ops.metrics as ops_metrics

        if self.fault is None:
            return
        if self.fault == "half_batch":
            original, module, name = eval_engine.ranking_metrics, eval_engine, "ranking_metrics"

            def broken(scores, relevance, mask, metrics, ks):
                h = max(scores.shape[0] // 2, 1)
                return original(scores[:h], relevance[:h], mask[:h], metrics, ks)
        elif self.fault == "altered_answer":
            original, module, name = ops_metrics.topk_lowest_index, ops_metrics, "topk_lowest_index"

            def broken(scores, k):
                values, idx = original(scores, k)
                return values.flip(1), idx.flip(1)
        else:
            raise ValueError(f"no fault {self.fault!r} for an evaluation cell")
        setattr(module, name, broken)
        self._undo.append((module, name, original))

    def call(self):
        self.passes.append(self.evaluator.evaluate())
        return self.n_users

    def outcome(self):
        first = self.passes[0]
        return len(self.passes) - 1, sum(out != first for out in self.passes[1:])

    def profiled(self, n):
        from torch.profiler import record_function

        for _ in range(n):
            with record_function("FullCatalogEvaluator.evaluate"):
                self.evaluator.evaluate()
        return n

    def dispatch(self, n):
        return []

    def release(self):
        for module, name, original in self._undo:
            setattr(module, name, original)
        del self.evaluator, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reading(self, tf32=False):
        """The reference's answer: the weights made again from the seed,
        full-catalog scores in blocks of users, train items masked, the
        held-out item's score and rank, every metric@k; with ``tf32`` the
        control's."""
        weights = self._weights()
        block = int(self.traffic["user_block"])
        items = torch.arange(self.n_items, device=self.device)
        sums, held = None, []
        with torch.no_grad():
            for lo in range(0, self.n_users, block):
                users = torch.arange(lo, min(lo + block, self.n_users), device=self.device)
                scores = self.ref.score_all(self.cfg, weights, users, self.inputs, tf32=tf32)
                held.append(scores.gather(1, self.rel_items[users][:, None])[:, 0])
                masked = data.is_positive(self.train_keys, users[:, None], items[None, :], self.n_items)
                part = metric_sums(held_out_ranks(scores, masked, self.rel_items[users]),
                                   self.traffic["metrics"], self.traffic["ks"])
                sums = part if sums is None else {k: sums[k] + v for k, v in part.items()}
        return {"metrics": {k: v / self.n_users for k, v in sums.items()}, "scores": torch.cat(held)}

    @staticmethod
    def numbers(output, reference):
        """``metric_gap`` of every pass of ``output`` ({"passes": [...],
        "scores": held-out scores}) against the reference's metrics, and
        ``score_gap``, the largest gap of a held-out item's score over the
        root mean square of the reference's."""
        ref = reference["scores"].double()
        gap = (output["scores"].double() - ref).abs().max() / ref.square().mean().sqrt().clamp(min=1e-30)
        return {"metric_gap": metric_gap(output["passes"], reference["metrics"]), "score_gap": float(gap)}

    def verify(self):
        return self.numbers({"passes": self.passes, "scores": self.held_out_scores}, self.reading())
