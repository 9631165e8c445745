"""Each cell driven end to end on the CPU at a tiny size with the kernels'
plain versions (the harness's look for a card skipped): the result line,
``correct`` against the plain reference, the faults that have to turn it
false, the control, and a cell, configuration, traffic mix and metric
added by new files and entries alone."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from conftest import BENCH, SEED, edit_json, make_tiny

CELLS = ["mf-ml20m.train-b1048576", "sasrec-ml1m.train-b512", "mf-ml20m.eval-full", "sasrec-ml1m.eval-full"]
TRAIN, EVAL = CELLS[:2], CELLS[2:]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run_cell(root, workload, trace=0, fault=None, seed=SEED, seconds=0.3):
    from harness.runner import run
    from harness.spec import load_cell

    return run(load_cell(root, workload), seed, seconds, trace, "cpu", time.perf_counter(), fault=fault)[0]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct_and_prints_the_contract_line(tiny, workload, trace):
    result = run_cell(tiny, workload, trace)
    assert RESULT_KEYS <= set(result) and list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    names = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]}
    assert set(result["metrics"]) <= names
    for value in result["metrics"].values():
        assert set(value) == {"value", "unit"} and value["value"] == value["value"]
    if not trace:
        assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    else:
        assert {"busy_s", "window_s"} <= set(result["device"])
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"]
    json.dumps(result)


@pytest.mark.parametrize("workload,fault", [(w, f) for w in TRAIN for f in ("unchanged", "half_batch")]
                         + [(w, f) for w in EVAL for f in ("half_batch", "altered_answer")])
def test_a_broken_timed_path_is_not_correct(tiny, workload, fault):
    assert run_cell(tiny, workload, fault=fault)["correct"] is False


@pytest.mark.parametrize("workload,number", [(w, "grad_norm_gap") for w in TRAIN] + [(w, "score_gap") for w in EVAL])
def test_the_tf32_control_reads_far_above_the_program(tiny, workload, number):
    """The reference computed in TF32 in the program's place: the number
    that separates the two (the first gradients' gap in training, the
    held-out scores' gap in evaluation) reads far above the program's at
    the same inputs, and above the cell's limit."""
    import readings
    from harness.spec import load_cell

    cell = load_cell(tiny, workload)
    program = readings.reading(cell, SEED, "cpu", "program")
    control = readings.reading(cell, SEED, "cpu", "control")
    assert control[number] > 10 * program[number]
    assert control[number] > cell.limits[number]


def test_a_new_cell_needs_new_files_and_entries_only(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    by new files and new entries: the harness finds them by name."""
    root = make_tiny(tmp_path)
    bench = root / BENCH.name
    conf = json.loads((bench / "configs" / "mf-ml20m.json").read_text())
    conf["model"]["emb_dim"] = 32
    (bench / "configs" / "mf-small.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "train-b1048576.json").read_text())
    traffic["batch_size"] = 128
    (bench / "traffic" / "train-b128.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "window_calls.train_mf_small.py").write_text(
        "def read(record):\n    return float(record.calls)\n")
    (bench / "limits" / "mf-small.train-b128.json").write_text(
        (bench / "limits" / "mf-ml20m.train-b1048576.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "mf-small", "source": "https://example.org/mf-small",
                            "file": f"{BENCH.name}/configs/mf-small.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "mf-small.train-b128", "config": "mf-small", "traffic": "train-b128",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "window_calls.train_mf_small", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "a test", "moves": "train_examples_per_s",
                              "workloads": ["mf-small.train-b128"]})
    spec["end_to_end"][0]["workloads"].append("mf-small.train-b128")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result = run_cell(root, "mf-small.train-b128", trace=1)
    assert result["correct"] and result["metrics"]["window_calls.train_mf_small"]["value"] >= 1
    assert set(run_cell(root, "mf-small.train-b128")["metrics"]) == {"train_examples_per_s", "setup_s"}


def _run_py(cwd, *extra):
    return subprocess.run([sys.executable, f"{BENCH.name}/run.py", "--workload", CELLS[0], "--seed", str(SEED),
                           "--seconds", "1", "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_the_command_fails_and_prints_no_result(tiny):
    proc = _run_py(tiny)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_benchmark_alone_without_the_program_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """One short run of the first cell through the command (the card's
    machine: ``python3 -m pytest port_bench/tests -m cuda``)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = _run_py(BENCH.parent)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
