"""The run layer against the JAX package: ``expand_grid``; ``tune`` in turn
and with two CPU workers (the counterpart of ``tests/test_tune_process_mode
.py``) and its ``tune_result.csv``; the three CLIs in subprocesses on a tiny
split with ``--device cpu``; ``Experiment``; ``system.log_to_file`` and
``run_time``; ``SeqEvalEngine`` against JAX's on the same scores (ties
included) and the sequential metrics."""

import csv
import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_mf import structured_split

from beta_recsys_tpu.core.seq_eval_engine import SeqEvalEngine as JaxSeqEvalEngine
from beta_recsys_tpu.experiment.tune import expand_grid as jax_expand_grid
from beta_recsys_tpu.utils import seq_evaluation as jax_seq_evaluation
from beta_recsys_tpu_torch.config import Config
from beta_recsys_tpu_torch.core.seq_eval_engine import SeqEvalEngine
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.experiment import Experiment, expand_grid, tune
from beta_recsys_tpu_torch.recommenders import MatrixFactorization
from beta_recsys_tpu_torch.utils import seq_evaluation
from beta_recsys_tpu_torch.utils.monitor import Monitor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
tune_module = importlib.import_module("beta_recsys_tpu_torch.experiment.tune")  # the package exports tune()
TUNABLE = [{"name": "lr", "type": "choice", "values": [0.1, 0.01]}]


@pytest.fixture(scope="module")
def data():
    return BaseData(structured_split())


def _config(root, max_epoch=2, **system):
    return Config({
        "system": {"root_dir": str(root), "metrics": ["ndcg"], "k": [10], "valid_metric": "ndcg", "valid_k": 10,
                   "seed": 2, **system},
        "dataset": {"dataset": "synthetic"},
        "model": {"model": "MF", "emb_dim": 8, "batch_size": 128, "loss": "bpr", "optimizer": "adam", "lr": 0.05,
                  "max_epoch": max_epoch, "max_n_update": max_epoch},
        "tunable": TUNABLE,
    })


@pytest.mark.parametrize("tunable", [
    TUNABLE,
    [{"name": "lr", "type": "range", "min": 1e-4, "max": 1e-1, "n": 4}, {"name": "emb_dim", "type": "choice",
                                                                        "values": [8, 16]}],
    [{"name": "reg", "type": "range", "values": [0.0, 0.5], "n": 3}],
    [{"name": "lr", "type": "range", "values": [0.5, 2.0], "scale": "log"}],
])
def test_expand_grid_matches_jax(tunable):
    assert expand_grid(tunable) == jax_expand_grid(tunable)


def test_expand_grid_rejects_what_jax_rejects():
    for spec in ([{"name": "x", "type": "weird"}], [{"name": "x", "type": "range", "values": [0, 1], "scale": "log"}]):
        with pytest.raises(ValueError):
            expand_grid(spec)


def _table(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_tune_in_turn_writes_the_jax_columns(tmp_path, data):
    result = tune(MatrixFactorization, _config(tmp_path), data, device="cpu")
    rows = _table(os.path.join(str(tmp_path), "tune_results", "tune_result.csv"))
    assert list(rows[0]) == ["lr", "valid_metric", "model_save_dir", "trial"]
    assert [float(r["lr"]) for r in rows] == [0.1, 0.01] and [r["trial"] for r in rows] == ["0", "1"]
    assert result["valid_metric"] == max(r["valid_metric"] for r in result["tune_result"])
    assert os.path.isdir(result["model_save_dir"])


def test_tune_with_two_cpu_workers(tmp_path, data):
    """One spawned interpreter a worker, each on the CPU with its share of
    the cores and a placement of its own."""
    result = tune(MatrixFactorization, _config(tmp_path), data, processes=2, device="cpu")
    rows = result["tune_result"]
    assert len(rows) == 2 and {r["lr"] for r in rows} == {0.1, 0.01}
    table = _table(os.path.join(str(tmp_path), "tune_results", "tune_result.csv"))
    assert list(table[0]) == ["lr", "valid_metric", "model_save_dir", "trial", "worker_pid",
                              "worker_partition_index", "worker_n_devices", "worker_platform"]
    assert {r["worker_partition_index"] for r in rows} <= {0, 1}
    assert len({r["worker_pid"] for r in rows}) == len({r["worker_partition_index"] for r in rows})
    assert all(r["worker_platform"] == "cpu" and r["worker_n_devices"] == 1 for r in rows)
    assert all(r["worker_pid"] != os.getpid() for r in rows)


def test_worker_placement_rules(monkeypatch):
    assert tune_module._worker_placements(2, [{"A": "1"}, {"A": "2"}], "cpu")[1] == {"env": {"A": "2"},
                                                                                   "partition_index": 1}
    with pytest.raises(ValueError, match="worker_env"):
        tune_module._worker_placements(3, [{}], "cpu")
    assert all(p["device"] == "cpu" for p in tune_module._worker_placements(2, None, "cpu"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tune_module._worker_placements(2, None, "cuda:0") is None  # one card: in turn
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    placements = tune_module._worker_placements(2, None, "cuda:0")
    assert [p["env"]["CUDA_VISIBLE_DEVICES"] for p in placements] == ["0", "1"]
    assert all(p["device"] == "cuda:0" for p in placements)


def test_one_card_without_worker_env_runs_in_turn(tmp_path, data, monkeypatch, capsys):
    monkeypatch.setattr(tune_module, "_worker_placements", lambda *a: None)
    result = tune(MatrixFactorization, _config(tmp_path, max_epoch=1), data, processes=2, device="cpu")
    assert len(result["tune_result"]) == 2 and "worker_pid" not in result["tune_result"][0]
    assert "running trials sequentially" in capsys.readouterr().out


def test_log_to_file_and_run_time(tmp_path, data):
    recommender = MatrixFactorization(_config(tmp_path, max_epoch=1, log_to_file=True), device="cpu")
    try:
        result = recommender.train(data)
        print("after training")
    finally:
        recommender.engine.run_logger.restore()
    assert result["run_time"] == recommender.run_time >= recommender.engine.run_time > 0
    with open(recommender.engine.run_logger.stdout_path) as f:
        lines = f.read().splitlines()
    assert any("[Epoch 0]" in line for line in lines) and lines[-1].endswith("after training")
    assert lines[0].startswith("[20")  # each line stamped
    assert os.path.dirname(recommender.engine.run_logger.stdout_path) == os.path.join(str(tmp_path), "logs")


def test_monitor_samples_and_returns_the_wall_clock():
    monitor = Monitor(delay=0.05, device="cpu")
    import time

    time.sleep(0.2)
    run_time = monitor.stop()
    assert run_time >= 0.2 and monitor.samples
    assert all(s["device_mem_mb"] == 0 for s in monitor.samples)


def test_experiment_runs_the_matrix(tmp_path, data):
    models = [MatrixFactorization(_config(tmp_path, max_epoch=1), device="cpu"),
              MatrixFactorization(_config(tmp_path, max_epoch=1).replace(model={"emb_dim": 4}), device="cpu")]
    experiment = Experiment([data], models, metrics=["ndcg", "recall"], eval_scopes=[5, 10], result_file="x.csv")
    rows = experiment.run()
    assert len(rows) == 2 and all({"model", "dataset", "valid_metric", "ndcg@5", "recall@5"} <= set(r) for r in rows)
    assert models[1].config.system.get("result_file") == "model_1_MF_x.csv"
    assert os.path.exists(os.path.join(str(tmp_path), "results", "model_0_MF_x.csv"))


# -- the CLIs ------------------------------------------------------------------------


def _cli(args, cwd, code=None):
    # One thread: beside a parallel test run's workers, more threads only spin.
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-c", code] if code else [sys.executable, "-m", *args]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_train_model_cli_on_the_cpu(tmp_path):
    out = _cli(["beta_recsys_tpu_torch.cli.train_model", "--model", "mf", "--dataset", "synthetic", "--max_epoch",
                "1", "--n_test", "1", "--root_dir", str(tmp_path / "runs"), "--device", "cpu"], str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "train result:" in out.stdout and "test result:" in out.stdout
    rows = _table(str(tmp_path / "runs" / "results" / "mf_result.csv"))
    assert len(rows) == 1 and float(rows[0]["ndcg@10"]) > 0
    assert os.path.exists(tmp_path / "datasets" / "synthetic" / "processed" / "leave_one_out" / "full_n_neg_100"
                          / "train.npz")  # built by the port's pipeline


def test_train_model_cli_defaults_to_cuda(tmp_path):
    code = ("import torch; torch.cuda.is_available = lambda: False\n"
            "from beta_recsys_tpu_torch.cli import train_model\n"
            "train_model.run_model(argv=['--model', 'mf', '--dataset', 'synthetic', '--n_test', '1'])")
    out = _cli(None, str(tmp_path), code)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_run_experiment_cli(tmp_path):
    """The three shipped configs at one epoch (a patched ``load_config``:
    the CLI takes only --dataset and --device, as the JAX one)."""
    code = ("from beta_recsys_tpu_torch.cli import run_experiment as m\n"
            "from beta_recsys_tpu_torch.config import load_config\n"
            "m.load_config = lambda path, over: load_config(\n"
            "    path, {**over, 'max_epoch': 1, 'n_test': 1, 'emb_dim': 8})\n"
            "rows = m.main(['--dataset', 'synthetic', '--device', 'cpu'])\n"
            "print('MODELS', [r['model'] for r in rows])")
    out = _cli(None, str(tmp_path), code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MODELS ['MF', 'NCF', 'lightgcn']" in out.stdout  # each config's own model name


def test_serve_topk_cli(tmp_path):
    out = _cli(["beta_recsys_tpu_torch.cli.serve_topk", "--dataset", "synthetic", "--max_epoch", "1", "--k", "5",
                "--users", "0,3,7", "--root_dir", str(tmp_path / "serve"), "--out", str(tmp_path / "top.csv"),
                "--device", "cpu"], str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    rows = _table(str(tmp_path / "top.csv"))
    assert list(rows[0]) == ["col_user", "col_item", "col_prediction", "rank"]
    assert len(rows) == 15 and [int(r["col_user"]) for r in rows[::5]] == [0, 3, 7]
    assert [int(r["rank"]) for r in rows[:5]] == [1, 2, 3, 4, 5]


# -- the session evaluator ------------------------------------------------------------

N_ITEMS, MAXLEN = 25, 6


def _score_table():
    """Scores by the profile's last item, rounded so rows hold ties."""
    return np.round(np.random.default_rng(0).random((N_ITEMS + 1, N_ITEMS)) * 4) / 4


def _sequences():
    rng = np.random.default_rng(1)
    return [list(rng.integers(1, N_ITEMS + 1, n)) for n in (1, 2, 5, 9, 3, 12)]


@pytest.mark.parametrize("given_k, look_ahead, scroll, step", [(1, 1, True, 1), (2, "all", True, 2),
                                                                (-2, 1, False, 1), (3, 2, True, 1)])
def test_seq_eval_engine_matches_jax(given_k, look_ahead, scroll, step):
    table = _score_table()
    sequences = _sequences()
    want = JaxSeqEvalEngine().sequential_evaluation(lambda blk: jnp.asarray(table[np.asarray(blk)[:, -1]]), sequences,
                                                    MAXLEN, given_k, look_ahead, 4, scroll, step, batch_size=4)
    calls = []

    def score_fn(profiles):
        calls.append(profiles.shape[0])
        return torch.as_tensor(table)[profiles[:, -1]]

    got = SeqEvalEngine().sequential_evaluation(score_fn, sequences, MAXLEN, given_k, look_ahead, 4, scroll, step)
    assert len(calls) == 1  # every point in one batch, one call
    assert list(got) == list(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-12), key


def test_seq_eval_engine_blocks_test_sequences_and_train_eval():
    table = _score_table()
    engine = SeqEvalEngine({"system": {"metrics": ["ndcg", "mrr", "map"]}})
    assert engine.metrics == ["ndcg", "mrr"]
    sequences = _sequences()
    one = engine.sequential_evaluation(lambda p: torch.as_tensor(table)[p[:, -1]], sequences, MAXLEN)
    blocks = engine.sequential_evaluation(lambda p: torch.as_tensor(table)[p[:, -1]], sequences, MAXLEN, batch_size=3)
    assert one == blocks
    frame = {"col_sequence": sequences}
    kept = SeqEvalEngine.get_test_sequences(frame, 2)
    assert [len(s) for s in kept] == [5, 9, 3, 12]
    out = engine.train_eval_seq(kept, kept, lambda p: torch.as_tensor(table)[p[:, -1]], MAXLEN)
    assert set(out) == {"valid_ndcg", "valid_mrr", "test_ndcg", "test_mrr"}
    with pytest.raises(ValueError):
        engine.sequential_evaluation(None, sequences, MAXLEN, given_k=0)
    assert engine.sequential_evaluation(None, [[1]], MAXLEN, given_k=3) == {"ndcg": 0.0, "mrr": 0.0}


@pytest.mark.parametrize("gt, pred", [([1, 2, 2], [2, 3, 1, 1]), ([5], [1, 2]), ([4, 4], [4]), ([[1, 2]], [[1, 2], 3])])
def test_sequential_metrics_match_jax(gt, pred):
    for name in ("precision", "recall", "mrr", "ndcg"):
        assert getattr(seq_evaluation, name)(gt, pred) == getattr(jax_seq_evaluation, name)(gt, pred), name
