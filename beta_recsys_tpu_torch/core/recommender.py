"""User-facing API: Model(config).train(data) or .load(dir, data), then
test() / predict() / recommend() / export_embeddings().

Counterpart of ``Recommender`` in ``beta_recsys_tpu/core/recommender.py``.
It runs on the GPU unless ``device="cpu"`` is passed; ``mesh_devices``
names the devices of ``system.mesh`` where they are not every CUDA device
(``TrainEngine``). After ``train`` the model holds the best checkpoint's
parameters, the model ``test()`` reports, and the engine keeps the
final-epoch ones aside: ``use_best=False`` serves those, and serving never
changes which parameters a later call sees (``TrainEngine.serving``). A
frame is a dict of numpy columns (``utils/common.py``); ``recommend``
returns such a dict.

``recommend`` routes as the JAX package does. A model with a factorized
form (``user_item_embeddings``) takes the fast route (``retrieval_topk``:
one matmul over the catalog, ``k`` + T candidates, each user's T train
items filtered out) while ``k`` + the largest train degree is at most 256,
else the streaming route (``streaming_topk`` over ``item_block`` items a
step with an exclusion mask); both pass their scores through
``retrieval_score_transform``. Other models score the catalog with
``score_all`` (SASRec through the flash forward kernel). The routes
exclude by the rules of their JAX counterparts: the fast route every
stored train entry (``exclusion_lists``), the other two the items whose
summed train rating is positive, so a zero-rated train row is excluded on
the first and kept on the others.
"""

import os
from contextlib import nullcontext

import numpy as np
import torch

from ..config import Config, load_config
from ..convert import flatten_params
from ..data.base_data import BaseData
from ..device import fp32_matmuls, resolve_device
from ..models import build_model
from ..ops.topk import exclusion_lists, retrieval_topk, streaming_topk, topk_lowest_index
from ..utils.monitor import Monitor
from ..utils.constants import DEFAULT_ITEM_COL, DEFAULT_PREDICTION_COL, DEFAULT_USER_COL
from .checkpoint import load_metadata, load_raw_checkpoint
from .eval_engine import FAST_RETRIEVAL_WIDTH
from .train_engine import TrainEngine, final_test, make_run_id


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
        self.model_run_id = None

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
        "best_epoch", "model_save_dir", "run_time"}, ``run_time`` the
        ``Monitor``'s wall clock over build and training. Validation runs on
        the first validation copy every epoch. With ``model.tune`` it runs
        the config's grid instead (``experiment/tune.py``) and returns the
        best trial."""
        if self.config.model.get("tune"):
            from ..experiment.tune import tune

            return tune(self.__class__, self.config, data, device=self.device)
        self.data = data
        self.model = self._build_model(data.n_users, data.n_items)
        self.engine = TrainEngine(self.config, self.device, self.mesh_devices)
        self.model_run_id = self.engine.model_run_id
        sys_cfg = self.config.system
        monitor = Monitor(log_dir=os.path.join(sys_cfg.get("root_dir", "."), sys_cfg.get("run_dir", "runs/")),
                          delay=1, device=self.device)
        valid_cand = data.eval_candidates(data.valid[0]) if data.valid else None
        test_cand = data.eval_candidates(data.test[0]) if data.test else None
        self.engine.build(self.model, data, valid_cand, test_cand)
        result = self.engine.train()
        self.run_time = result["run_time"] = monitor.stop()
        self.engine.hold_best()
        self.model.eval()
        return result

    def load(self, model_dir, data=None):
        """Build the model from a checkpoint directory (the JAX package's or
        the port's): n_users/n_items from ``metadata.json``, parameters from
        ``raw["params"]`` of ``checkpoint.msgpack`` (row tables a sharded run
        padded are cut back to the real rows). Models whose scoring needs
        derived artifacts (sequence contexts) need ``data``. On a
        recommender that has trained, it restores the engine's whole state
        from the directory instead (``TrainEngine.resume_checkpoint``), as
        the JAX package does."""
        if self.engine is not None:
            self.engine.resume_checkpoint(model_dir)
            return self
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
        raw = load_raw_checkpoint(model_dir, backend=self.config.system.get("checkpoint_backend"))
        self.model.load_trimmed(self.params_from_jax(raw["params"]))
        self.model.eval()
        return self

    def _serving(self, use_best):
        """The block in which the model holds the parameters to serve: the
        best checkpoint's (``use_best``) or the final-epoch ones. A loaded
        model has only the checkpoint's."""
        return self.engine.serving(use_best) if self.engine is not None else nullcontext(self.model)

    def test(self, test_df=None):
        """Final evaluation over every test candidate copy of the data (or the
        given frame(s)) with the best checkpoint; appends the mean row to the
        config's result CSV under ``system.root_dir`` and, with
        ``system.save_mode`` "per_user", writes the first copy's scored
        candidates to ``<result_dir>/<model_run_id>_per_user.csv``."""
        if self.model is None or self.data is None:
            raise ValueError("call train(data) or load(model_dir, data) first")
        if test_df is None:
            tests = self.data.test
        elif isinstance(test_df, dict):
            tests = [test_df]
        else:
            tests = list(test_df)
        if self.model_run_id is None:  # a loaded model: a run id of its own, as the JAX package's load makes
            self.model_run_id = make_run_id(self.config.model)
        result_para = {
            "model": self.config.model.get("model"),
            "dataset": self.config.dataset.get("dataset"),
            "data_split": self.config.dataset.get("data_split"),
        }
        with self._serving(True):
            return final_test(self.config, self.test_model(), [self.data.eval_candidates(df) for df in tests],
                              self.model_run_id, result_para,
                              self.engine.run_time if self.engine is not None else None)

    @torch.no_grad()
    def predict(self, data_df, use_best=True):
        """Scores of the (user, item) pairs of a frame, as a numpy array;
        ``use_best`` as in ``recommend``."""
        if self.model is None:
            raise ValueError("call load() first")
        users = _ids(data_df[DEFAULT_USER_COL], self.model.n_users, "user")
        items = _ids(data_df[DEFAULT_ITEM_COL], self.model.n_items, "item")
        with self._serving(use_best) as model:
            scores = model.score_pairs(
                torch.as_tensor(users, device=self.device), torch.as_tensor(items, device=self.device)
            )
            return scores.cpu().numpy()

    @torch.no_grad()
    def recommend(self, users=None, k=10, exclude_train=True, user_block=4096, item_block=8192, use_best=True,
                  mode="exact", score_dtype=None):
        """Top-k items per user over the catalog, train items excluded (see
        the module's docstring for the three routes and their rules), ties
        toward the lowest item id. ``use_best`` serves the best checkpoint
        (else the final-epoch parameters); ``mode`` and ``score_dtype`` go
        to the fast route's ``retrieval_topk``. bfloat16 scores halve the
        score matrix, but they tie far more often and every tied row takes
        the exact tie-order route, so on an H100 they were measured slower
        than float32 (PERF.md, section 6). ``item_block`` is the streaming
        route's block.

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
        users = np.arange(self.model.n_users) if users is None else _ids(users, self.model.n_users, "user")
        train_csr = self.data.user_item_csr() if exclude_train else None
        excl_all = exclusion_lists(train_csr) if train_csr is not None else None
        out_items, out_scores = [], []
        with self._serving(use_best):
            model = self.test_model()
            # a graph model propagates once, not once a block
            with model.holding_embeddings():
                embs = model.user_item_embeddings_trimmed()
                route = recommend_route(embs is not None, k, excl_all)
                for start in range(0, len(users), user_block):
                    blk = users[start:start + user_block]
                    blk_t = torch.as_tensor(blk, device=self.device)
                    if route == "fast":
                        ex = None if excl_all is None else torch.as_tensor(excl_all[blk], device=self.device)
                        values, idx = retrieval_topk(embs[0][blk_t], embs[1], k, exclude_list=ex, mode=mode,
                                                     score_dtype=score_dtype)
                        values = model.retrieval_score_transform(values)
                    elif route == "streaming":
                        mask = self._train_mask(train_csr, blk, model.n_items)
                        values, idx = streaming_topk(embs[0][blk_t], embs[1], k, block=item_block,
                                                     exclude_mask=mask)
                        values = model.retrieval_score_transform(values)
                    else:
                        scores = model.score_all(blk_t)[:, : model.n_items]
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

    @torch.no_grad()
    def export_embeddings(self, path, use_best=True):
        """Write the model's final (user, item) tables to ``path`` with
        ``np.savez_compressed`` as ``user_emb`` and ``item_emb``: for a
        propagation model (LightGCN, ...) the PROPAGATED tables, so their dot
        products are the model's scores with no graph at query time. Raises
        for a model with no factorized form. Returns ``path``."""
        if self.model is None:
            raise ValueError("call train() or load() first")
        with self._serving(use_best):
            model = self.test_model()
            embs = model.user_item_embeddings_trimmed()
            if embs is None:
                raise ValueError(
                    f"{type(model).__name__} has no factorized (user_emb, item_emb) form; "
                    "serve it through recommend() instead"
                )
            np.savez_compressed(path, user_emb=embs[0].cpu().numpy(), item_emb=embs[1].cpu().numpy())
        return path

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


def recommend_route(factorized, k, exclusion):
    """"fast", "streaming" or "score_all": the route ``recommend`` takes
    for a model with or without a factorized form, ``k`` results and the
    per-user exclusion lists (None when nothing is excluded)."""
    if not factorized:
        return "score_all"
    return "fast" if exclusion is None or exclusion.shape[1] + k <= FAST_RETRIEVAL_WIDTH else "streaming"


def _ids(values, n, kind):
    """Dense ids as int64, checked on the host: an out-of-range index on the
    device would end the process's CUDA context instead of raising."""
    ids = np.asarray(values).astype(np.int64, copy=False)
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(f"{kind} ids must lie in [0, {n}); got {ids.min()}..{ids.max()}")
    return ids
