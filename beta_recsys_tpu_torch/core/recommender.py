"""User-facing API: Model(config).train(data) or .load(dir, data), then
test() / predict() / recommend().

Counterpart of ``Recommender`` in ``beta_recsys_tpu/core/recommender.py``.
It runs on the GPU unless ``device="cpu"`` is passed; ``mesh_devices``
names the devices of ``system.mesh`` where they are not every CUDA device
(``TrainEngine``). After ``train`` the
model holds the best checkpoint's parameters, the model ``test()`` reports,
as the JAX package serves ``_serving_params(use_best=True)``. A frame is a
dict of numpy columns (``datasets/split_io.py``); ``recommend`` returns such
a dict.
"""

import os

import numpy as np
import torch

from ..config import Config, load_config
from ..convert import flatten_params
from ..data.base_data import BaseData
from ..device import fp32_matmuls, resolve_device
from ..models import build_model
from ..ops.topk import topk_lowest_index
from ..utils.constants import DEFAULT_ITEM_COL, DEFAULT_PREDICTION_COL, DEFAULT_USER_COL
from .checkpoint import load_metadata, load_raw_checkpoint
from .eval_engine import RankingEvaluator, test_eval
from .train_engine import TrainEngine


class Recommender:
    """Generic config-driven recommender wrapper."""

    model_name = None  # registry key override; defaults to the config's model
    data_class = BaseData

    def __init__(self, config, device=None, mesh_devices=None):
        if isinstance(config, str):
            config = load_config(config)
        elif not isinstance(config, Config):
            config = Config(config)
        self.config = config
        self.device = resolve_device(device)
        self.mesh_devices = mesh_devices
        fp32_matmuls()
        self.model = None
        self.data = None
        self.engine = None
        self.run_time = None

    # -- hooks ---------------------------------------------------------------------

    def build_artifacts(self, data):
        """Derived model inputs (e.g. sequence contexts)."""
        return {}

    def test_model(self):
        """The model used for final-test scoring and recommend(); sequence
        recommenders extend each user's context with validation items."""
        return self.model

    # The model's state_dict from a JAX params tree (``convert.py``).
    params_from_jax = staticmethod(flatten_params)

    # -- API -----------------------------------------------------------------------

    def _build_model(self, n_users, n_items):
        model_cfg = self.config.model
        if self.model_name is not None:
            model_cfg = model_cfg.replace(model=self.model_name)
        artifacts = self.build_artifacts(self.data) if self.data is not None else {}
        return build_model(model_cfg, n_users, n_items, artifacts, self.device)

    def init(self, data, generator):
        """Build the model for ``data`` with fresh weights from the model's
        initializer, drawn from the CPU ``torch.Generator`` given."""
        self.data = data
        self.model = self._build_model(data.n_users, data.n_items).init_weights(generator)
        self.model.eval()
        return self

    def train(self, data):
        """Train on ``data`` (a ``BaseData``); returns {"valid_metric",
        "best_epoch", "model_save_dir", "run_time"}. Validation runs on the
        first validation copy every epoch."""
        self.data = data
        self.model = self._build_model(data.n_users, data.n_items)
        self.engine = TrainEngine(self.config, self.device, self.mesh_devices)
        valid_cand = data.eval_candidates(data.valid[0]) if data.valid else None
        test_cand = data.eval_candidates(data.test[0]) if data.test else None
        self.engine.build(self.model, data, valid_cand, test_cand)
        result = self.engine.train()
        self.run_time = result["run_time"]
        if self.engine.has_checkpoint("best"):
            self.model.load_trimmed(self.params_from_jax(self.engine.load_params()))
        self.model.eval()
        return result

    def load(self, model_dir, data=None):
        """Build the model from a JAX checkpoint directory: n_users/n_items
        from ``metadata.json``, parameters from ``raw["params"]`` of
        ``checkpoint.msgpack`` (row tables a sharded run padded are cut back
        to the real rows). Models whose scoring needs derived artifacts
        (sequence contexts) need ``data``."""
        meta = load_metadata(model_dir)
        n_users, n_items = meta.get("n_users"), meta.get("n_items")
        if n_users is None or n_items is None:
            raise ValueError(f"checkpoint at {model_dir} lacks n_users/n_items metadata")
        if data is not None:
            if (data.n_users, data.n_items) != (n_users, n_items):
                raise ValueError(
                    f"data has {data.n_users} users x {data.n_items} items, the checkpoint "
                    f"{n_users} x {n_items}"
                )
            self.data = data
        self.model = self._build_model(int(n_users), int(n_items))
        raw = load_raw_checkpoint(model_dir)
        self.model.load_trimmed(self.params_from_jax(raw["params"]))
        self.model.eval()
        return self

    def test(self, test_df=None):
        """Final evaluation over every test candidate copy of the data (or the
        given frame(s)); appends the mean row to the config's result CSV under
        ``system.root_dir``."""
        if self.model is None or self.data is None:
            raise ValueError("call train(data) or load(model_dir, data) first")
        if test_df is None:
            tests = self.data.test
        elif isinstance(test_df, dict):
            tests = [test_df]
        else:
            tests = list(test_df)
        sys_cfg = self.config.system
        metrics = tuple(sys_cfg.get("metrics", ["ndcg", "precision", "recall", "map"]))
        ks = tuple(sys_cfg.get("k", [5, 10, 20]))
        model = self.test_model()
        evaluators = [
            RankingEvaluator(model, self.data.eval_candidates(df), metrics, ks) for df in tests
        ]
        result_file = os.path.join(
            sys_cfg.get("root_dir", "."),
            sys_cfg.get("result_dir", "results/"),
            sys_cfg.get("result_file", "result.csv"),
        )
        result_para = {
            "model": self.config.model.get("model"),
            "dataset": self.config.dataset.get("dataset"),
            "data_split": self.config.dataset.get("data_split"),
        }
        mean_row, _ = test_eval(evaluators, result_file=result_file, result_para=result_para, run_time=self.run_time)
        return mean_row

    @torch.no_grad()
    def predict(self, data_df):
        """Scores of the (user, item) pairs of a frame, as a numpy array."""
        if self.model is None:
            raise ValueError("call load() first")
        users = _ids(data_df[DEFAULT_USER_COL], self.model.n_users, "user")
        items = _ids(data_df[DEFAULT_ITEM_COL], self.model.n_items, "item")
        scores = self.model.score_pairs(
            torch.as_tensor(users, device=self.device), torch.as_tensor(items, device=self.device)
        )
        return scores.cpu().numpy()

    @torch.no_grad()
    def recommend(self, users=None, k=10, exclude_train=True, user_block=4096):
        """Top-k items per user: full-catalog scores, train items excluded,
        ties broken toward the lowest item id.

        Returns {col_user, col_item, col_prediction, "rank"}: numpy arrays of
        len(users) * k rows, each user's k rows in rank order.
        """
        if self.model is None:
            raise ValueError("call load() first")
        if exclude_train and self.data is None:
            raise ValueError(
                "exclude_train=True needs the training data to know which items to "
                "exclude: pass data= to load(), or exclude_train=False"
            )
        model = self.test_model()
        users = np.arange(model.n_users) if users is None else _ids(users, model.n_users, "user")
        train_csr = self.data.user_item_csr() if exclude_train else None
        out_items, out_scores = [], []
        with model.holding_embeddings():  # a graph model propagates once, not once a block
            for start in range(0, len(users), user_block):
                blk = users[start:start + user_block]
                scores = model.score_all(torch.as_tensor(blk, device=self.device))
                scores = scores[:, : model.n_items]
                if train_csr is not None:
                    scores = scores.masked_fill(self._train_mask(train_csr, blk, model.n_items), -torch.inf)
                values, idx = topk_lowest_index(scores, k)
                out_scores.append(values.cpu().numpy().reshape(-1))
                out_items.append(idx.cpu().numpy().reshape(-1))
        return {
            DEFAULT_USER_COL: np.repeat(users, k),
            DEFAULT_ITEM_COL: np.concatenate(out_items) if out_items else np.zeros(0, np.int64),
            DEFAULT_PREDICTION_COL: np.concatenate(out_scores) if out_scores else np.zeros(0, np.float32),
            "rank": np.tile(np.arange(1, k + 1), len(users)),
        }

    def _train_mask(self, train_csr, users, n_items):
        """(len(users), n_items) bool on the device: True where the user's
        summed train rating is positive."""
        sub = train_csr[users]
        rows = np.repeat(np.arange(len(users)), np.diff(sub.indptr))
        keep = sub.data > 0
        mask = torch.zeros((len(users), n_items), dtype=torch.bool, device=self.device)
        mask[torch.as_tensor(rows[keep], device=self.device),
             torch.as_tensor(sub.indices[keep], dtype=torch.long, device=self.device)] = True
        return mask


def _ids(values, n, kind):
    """Dense ids as int64, checked on the host: an out-of-range index on the
    device would end the process's CUDA context instead of raising."""
    ids = np.asarray(values).astype(np.int64, copy=False)
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(f"{kind} ids must lie in [0, {n}); got {ids.min()}..{ids.max()}")
    return ids
