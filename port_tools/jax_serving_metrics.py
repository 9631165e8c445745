#!/usr/bin/env python3
"""The JAX package's test() metrics of the seed-0 Triple2vec checkpoint and of
UserKNN and ItemKNN on the structured synthetic split.

    JAX_PLATFORMS=cpu python port_tools/jax_serving_metrics.py [Triple2vec] [UserKNN] [ItemKNN]

Loads ``parity_runs/checkpoints/Triple2vec_default_20260821_165054_qjaaht``
into ``beta_recsys_tpu``'s Triple2vec recommender over the structured split
(leave-one-out, 100 negatives, one evaluation copy) with the synthetic
baskets of ``examples/parity_check.py``, and trains UserKNN and ItemKNN at
``configs/userKNN_default.json`` and ``itemKNN_default.json``
(neighbourhood_size 50; training is one evaluation) on the same split, and
prints each test() row: ``chip_smoke.py``'s ``EXPECTED_TRIPLE2VEC_METRICS``
and ``EXPECTED_KNN_METRICS``, which the port on the card must reproduce to
1e-6. The script turns XLA's constant folding off (``XLA_FLAGS``): the
KNN models hold their interaction matrix as a constant, which XLA would
otherwise fold for more than 15 minutes (UserKNN's metrics agree either way
to 1e-8); the three take ~15 s.
"""

import json
import os
import sys
import tempfile

from jax_mf_band import REPO, SPLIT

TRIPLE2VEC_CHECKPOINT = "parity_runs/checkpoints/Triple2vec_default_20260821_165054_qjaaht"
KNN_CONFIGS = {"UserKNN": "configs/userKNN_default.json", "ItemKNN": "configs/itemKNN_default.json"}


def main():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_disable_hlo_passes=constant_folding").strip()
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from beta_recsys_tpu import recommenders
    from beta_recsys_tpu.config import Config, load_config
    from beta_recsys_tpu.core.checkpoint import load_metadata
    from beta_recsys_tpu.data.base_data import BaseData
    from beta_recsys_tpu.data.grocery_data import GroceryData
    from beta_recsys_tpu.datasets.data_split import load_split_data
    from beta_recsys_tpu.datasets.synthetic import add_synthetic_baskets

    names = sys.argv[1:] or ["Triple2vec", *KNN_CONFIGS]
    train, valid, test = load_split_data(SPLIT, n_test=1)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for name in names:
            if name == "Triple2vec":
                path = os.path.join(REPO, TRIPLE2VEC_CHECKPOINT)
                rec = recommenders.Triple2vec(Config(load_metadata(path)["config"]).replace(system={"root_dir": root}))
                rec.load(path, GroceryData((add_synthetic_baskets(train), valid, test)))
            else:
                rec = getattr(recommenders, name)(load_config(os.path.join(REPO, KNN_CONFIGS[name])).replace(
                    system={"root_dir": root, "seed": 0}, dataset={"dataset": "synthetic_structured", "n_test": 1}))
                rec.train(BaseData((train, valid, test)))
            out[name] = {key: value for key, value in rec.test().items() if "@" in key}
            print(json.dumps({"model": name, **out[name]}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
