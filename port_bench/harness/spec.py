"""The cell a run measures, read from ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or metric is a file
of its own, found by its name:

  configs/<config>.json     sizes, model block, source (the entry's ``file``)
  traffic/<traffic>.json    the driver that runs the mix and its parameters
  drivers/<driver>.py       one kind of measured window
  metrics/<metric>.py       one metric's reader (end-to-end and per-layer)
  limits/<workload>.json    the limit of each number ``correct`` compares
  reference/<family>.py     a model family's plain reference and its weights
"""

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """Import the Python file at ``path`` as a module called ``name`` (file
    names may hold dots and dashes, which ``import`` cannot spell)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    root: Path  # the checkout: BENCHMARK.json beside the benchmark's folder
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # metric entries this cell reports with --trace 0
    per_layer: list = field(default_factory=list)  # and with --trace 1

    @property
    def bench_dir(self):
        return self.root / BENCH_DIR.name

    def driver(self):
        name = self.traffic["driver"]
        return load_module(self.bench_dir / "drivers" / f"{name}.py", f"port_bench_driver_{name}")

    def reference(self):
        name = self.config["reference"]
        return load_module(self.bench_dir / "reference" / f"{name}.py", f"port_bench_reference_{name}")

    def reader(self, metric):
        path = self.bench_dir / "metrics" / f"{metric}.py"
        return load_module(path, "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def _reported(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root, workload):
    """The ``Cell`` of ``workload`` in the checkout at ``root``; raises
    ``KeyError`` for a workload ``BENCHMARK.json`` does not list."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    end_to_end = [m for m in bench["end_to_end"] if _reported(m, workload)]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    bench_dir = root / BENCH_DIR.name
    limits_path = bench_dir / "limits" / f"{workload}.json"
    return Cell(
        root=root, name=workload, chips=int(entry["chips"]),
        config_name=conf["name"], config=load_json(root / conf["file"]),
        traffic_name=entry["traffic"], traffic=load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(limits_path) if limits_path.exists() else {},
        end_to_end=end_to_end, per_layer=per_layer,
    )
