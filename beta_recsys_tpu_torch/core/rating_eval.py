"""Rating-prediction evaluation (explicit feedback): rmse, mae, rsquared,
exp_var, auc and logloss.

Counterpart of ``beta_recsys_tpu/core/rating_eval.py``: the (user, item,
rating) rows of an evaluation frame are scored with ``score_pairs`` in one
call and reduced on the model's device (``ops/metrics.py``'s rating
reductions); the values reach the host in one transfer.
"""

import numpy as np
import torch

from ..ops.metrics import RATING_METRICS
from ..utils.constants import DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_USER_COL


class RatingEvaluator:
    """Pointwise evaluation over a frame's explicit ratings."""

    def __init__(self, model, eval_df, metrics=("rmse", "mae")):
        unknown = [m for m in metrics if m not in RATING_METRICS]
        if unknown:
            raise ValueError(f"Unknown rating metrics {unknown}; known: {sorted(RATING_METRICS)}")
        self.model = model
        self.metrics = tuple(metrics)
        device = model.device
        self.users = torch.as_tensor(np.asarray(eval_df[DEFAULT_USER_COL]), dtype=torch.long, device=device)
        self.items = torch.as_tensor(np.asarray(eval_df[DEFAULT_ITEM_COL]), dtype=torch.long, device=device)
        self.ratings = torch.as_tensor(np.asarray(eval_df[DEFAULT_RATING_COL], dtype=np.float32), device=device)

    @torch.no_grad()
    def evaluate(self):
        """{metric: float} for the model's current parameters."""
        preds = self.model.score_pairs(self.users, self.items)
        values = torch.stack([RATING_METRICS[m](self.ratings, preds) for m in self.metrics]).cpu().tolist()
        return dict(zip(self.metrics, values))
