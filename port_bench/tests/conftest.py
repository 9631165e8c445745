"""A tiny copy of the benchmark for the CPU tests: ``BENCHMARK.json`` and
``port_bench/`` copied into a temporary checkout, the configurations cut to
a few dozen users, the batches and blocks to match, the program's package
linked beside them. The cells run there on the CPU with the kernels' plain
versions."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO)]

TINY_DATA = {
    "mf-ml20m": {"n_users": 64, "n_items": 50, "n_interactions": 1600, "max_per_user": 40},
    "sasrec-ml1m": {"n_users": 64, "n_items": 60, "n_interactions": 1920, "max_per_user": 45},
}
TINY_MODEL = {"sasrec-ml1m": {"maxlen": 16, "emb_dim": 16}}
TINY_TRAFFIC = {"train-b1048576": {"batch_size": 256}, "train-b512": {"batch_size": 16}, "eval-full": {"user_block": 24}}
SEED = 2**33 + 7  # more than 32 bits, as the benchmark's seeds may be


def edit_json(path, **updates):
    data = json.loads(path.read_text())
    for key, value in updates.items():
        if isinstance(value, dict):
            data[key].update(value)
        else:
            data[key] = value
    path.write_text(json.dumps(data, indent=1))


def make_tiny(root):
    shutil.copytree(BENCH, root / BENCH.name, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "beta_recsys_tpu_torch").symlink_to(REPO / "beta_recsys_tpu_torch")
    for name, data in TINY_DATA.items():
        edit_json(root / BENCH.name / "configs" / f"{name}.json", data=data, model=TINY_MODEL.get(name, {}))
    for name, params in TINY_TRAFFIC.items():
        path = root / BENCH.name / "traffic" / f"{name}.json"
        if path.exists():
            edit_json(path, **params)
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("tiny_checkout"))
