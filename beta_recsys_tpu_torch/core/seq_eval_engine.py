"""Session evaluation by the scroll (next-item) protocol.

Counterpart of ``beta_recsys_tpu/core/seq_eval_engine.py``: for each test
sequence, the recommendations from a ``given_k`` prefix are held against the
next ``look_ahead`` items, the prefix scrolled forward by ``step`` with
``scroll``; each sequence's metrics are the mean over its points, and the
result the mean over sequences (``utils/seq_evaluation.py``). Every
(sequence, prefix) point is expanded first and padded into one batch, scored
in one call (or blocks of ``batch_size``), and its top-n taken on the device
with ``lax.top_k``'s tie order (``ops/topk.py``); only the id lists come back
to the host for the list metrics.
"""

import numpy as np
import torch

from ..ops.topk import topk_lowest_index
from ..utils import seq_evaluation

METRIC_FNS = {
    "precision": seq_evaluation.precision,
    "recall": seq_evaluation.recall,
    "mrr": seq_evaluation.mrr,
    "ndcg": seq_evaluation.ndcg,
}


class SeqEvalEngine:
    """Batched scroll-protocol evaluator for session recommenders."""

    def __init__(self, config=None, metrics=("precision", "recall", "mrr", "ndcg")):
        if config is not None:
            sys_cfg = config["system"] if "system" in config else config
            metrics = [m for m in sys_cfg.get("metrics", metrics) if m in METRIC_FNS] or list(metrics)
        self.metrics = list(metrics)

    @staticmethod
    def get_test_sequences(test_data, given_k, col_sequence="col_sequence"):
        """The sequences of a frame's ``col_sequence`` longer than |given_k|."""
        sequences = test_data[col_sequence]
        keep = np.asarray([len(s) > abs(given_k) for s in sequences], dtype=bool)
        return np.asarray(sequences, dtype=object)[keep] if len(sequences) else np.asarray([], dtype=object)

    @staticmethod
    def _expand_eval_points(test_sequences, given_k, look_ahead, scroll, step):
        """Every (owner, profile, ground truth) point of the sequences."""
        points = []
        for i, seq in enumerate(test_sequences):
            seq = list(seq)
            gk = given_k if given_k >= 0 else len(seq) + given_k
            for g in (range(gk, len(seq), step) if scroll else [gk]):
                profile, gt = seq[:g], seq[g:]
                if look_ahead != "all":
                    gt = gt[:look_ahead]
                if profile and gt:
                    points.append((i, profile, gt))
        return points

    def sequential_evaluation(self, score_fn, test_sequences, maxlen, given_k=1, look_ahead=1, top_n=10, scroll=True,
                              step=1, batch_size=None, device=None):
        """{metric: mean over sequences of each sequence's mean over its
        points}. ``score_fn`` maps (B, maxlen) int64 left-padded 1-indexed
        profiles (0 pads) on ``device`` (the CPU when None) to (B, n_items)
        scores over 0-indexed items."""
        if given_k == 0:
            raise ValueError("given_k must be != 0")
        points = self._expand_eval_points(test_sequences, given_k, look_ahead, scroll, step)
        if not points:
            return {m: 0.0 for m in self.metrics}
        profiles = np.zeros((len(points), maxlen), dtype=np.int64)
        for r, (_, profile, _) in enumerate(points):
            tail = profile[-maxlen:]
            profiles[r, maxlen - len(tail):] = tail
        profiles = torch.as_tensor(profiles, device=device)
        block = batch_size or len(points)
        with torch.no_grad():
            top = torch.cat([topk_lowest_index(score_fn(profiles[s:s + block]), top_n)[1]
                             for s in range(0, len(points), block)]).cpu().numpy()
        n_seq = len(test_sequences)
        seq_sums = {m: np.zeros(n_seq) for m in self.metrics}
        seq_counts = np.zeros(n_seq)
        for r, (owner, _, gt) in enumerate(points):
            reco = [int(x) + 1 for x in top[r]]  # back to 1-indexed ids
            for m in self.metrics:
                seq_sums[m][owner] += METRIC_FNS[m](gt, reco)
            seq_counts[owner] += 1
        active = seq_counts > 0
        return {m: float(np.where(active, seq_sums[m] / np.maximum(seq_counts, 1), 0.0).sum() / n_seq)
                for m in self.metrics}

    def train_eval_seq(self, valid_sequences, test_sequences, score_fn, maxlen, epoch_id=0, given_k=1, look_ahead=1,
                       top_n=10, scroll=True, step=1, device=None):
        """The valid and test sequences' metrics, keyed "valid_<m>" and
        "test_<m>", printed once."""
        results = {}
        for tag, seqs in (("valid", valid_sequences), ("test", test_sequences)):
            if seqs is None or len(seqs) == 0:
                continue
            res = self.sequential_evaluation(score_fn, seqs, maxlen, given_k, look_ahead, top_n, scroll, step,
                                             device=device)
            results.update({f"{tag}_{m}": v for m, v in res.items()})
        print(f"[Seq eval epoch {epoch_id}] " + " ".join(f"{k}={v:.4f}" for k, v in results.items()))
        return results
