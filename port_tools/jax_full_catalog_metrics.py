#!/usr/bin/env python3
"""The JAX package's full-catalog metrics of the seed-0 MF, LightGCN and
SASRec checkpoints on the structured synthetic split.

    JAX_PLATFORMS=cpu python port_tools/jax_full_catalog_metrics.py [MF] [LightGCN] [SASRec]

Loads each checkpoint (``CHECKPOINTS``) into ``beta_recsys_tpu``'s
recommender over the structured split (leave-one-out, 100 negatives, one
evaluation copy) and evaluates its test model over the whole catalog:
``FullCatalogEvaluator`` for the three, and ``TopKRetrievalEvaluator``
(mode "exact") for the two factorized ones. The users are those with a
positive (rating >= 1) in the first test copy, the relevance is those
positives, and the train interactions are excluded (``relevance``). It
prints one JSON line a model, then all of them: ``chip_smoke.py``'s
``EXPECTED_FULL_CATALOG_METRICS``, which the port on the card must
reproduce to 1e-6. The script turns XLA's constant folding off
(``XLA_FLAGS``), which would otherwise fold LightGCN's adjacency at length;
the three take ~25 s on a CPU.
"""

import json
import os
import sys

import numpy as np
import scipy.sparse as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100")
CHECKPOINTS = {
    "MF": "parity_runs/checkpoints/MF_default_20260821_134231_aaquvl",
    "LightGCN": "parity_runs/checkpoints/lightgcn_default_20260821_134437_yybcvt",
    "SASRec": "parity_runs/checkpoints/SASRec_default_20260821_081415_yybcvt",
}
CLASSES = {"MF": "MatrixFactorization", "LightGCN": "LightGCN", "SASRec": "SASRec"}


def relevance(users, items, ratings, n_users, n_items):
    """(users, relevance CSR): the users with a positive (rating >= 1) in an
    evaluation frame, sorted, and those positives as ones."""
    pos = np.asarray(ratings) >= 1
    u, i = np.asarray(users)[pos].astype(np.int64), np.asarray(items)[pos].astype(np.int64)
    csr = sp.csr_matrix((np.ones(len(u), np.float32), (u, i)), shape=(n_users, n_items))
    return np.unique(u), csr


def full_catalog_metrics(names=tuple(CHECKPOINTS)):
    """{model: {"full_catalog": {metric@k: value}, "topk_retrieval": ...}}."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_disable_hlo_passes=constant_folding").strip()
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from beta_recsys_tpu import recommenders
    from beta_recsys_tpu.config import Config
    from beta_recsys_tpu.core.checkpoint import load_metadata
    from beta_recsys_tpu.core.eval_engine import FullCatalogEvaluator, TopKRetrievalEvaluator
    from beta_recsys_tpu.data.base_data import BaseData
    from beta_recsys_tpu.data.sequential_data import SequentialData
    from beta_recsys_tpu.datasets.data_split import load_split_data
    from beta_recsys_tpu.utils.constants import DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_USER_COL

    split = load_split_data(SPLIT, n_test=1)
    out = {}
    for name in names:
        path = os.path.join(REPO, CHECKPOINTS[name])
        data = (SequentialData if name == "SASRec" else BaseData)(split)
        rec = getattr(recommenders, CLASSES[name])(Config(load_metadata(path)["config"])).load(path, data)
        test = data.test[0]
        users, rel = relevance(test[DEFAULT_USER_COL], test[DEFAULT_ITEM_COL], test[DEFAULT_RATING_COL],
                               data.n_users, data.n_items)
        model, params, train = rec.test_model(), rec.engine.params, data.user_item_csr()
        out[name] = {"full_catalog": FullCatalogEvaluator(model, users, rel, train).evaluate(params)}
        if name != "SASRec":
            out[name]["topk_retrieval"] = TopKRetrievalEvaluator(model, users, rel, train).evaluate(params)
        print(json.dumps({"model": name, **out[name]}), flush=True)
    return out


if __name__ == "__main__":
    print(json.dumps(full_catalog_metrics(tuple(sys.argv[1:]) or tuple(CHECKPOINTS))))
