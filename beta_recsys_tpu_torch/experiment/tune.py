"""Hyperparameter sweep: grid expansion and independent trials.

Counterpart of ``beta_recsys_tpu/experiment/tune.py``: the config's
``tunable`` specs expand into a grid (``expand_grid``, the JAX package's
rule); each trial is an independent training, run in turn in this process or,
with ``processes``, one spawned interpreter a worker; the rows go into
``<root>/<tune_dir>/tune_result.csv`` with the JAX package's columns.

Worker placement (``_worker_placements``): ``worker_env`` (one env dict a
worker) is applied as given; on the CPU every worker trains with
``device="cpu"`` on its share of the cores; on CUDA each worker sees one card
through ``CUDA_VISIBLE_DEVICES``. With one card and no ``worker_env`` the
trials run in turn, with the JAX package's warning.
"""

import itertools
import os

from ..utils.common import ensure_dir, save_to_csv


def expand_grid(tunable):
    """The tunable specs as a list of {name: value} dicts: "choice" specs
    give their values; a "range" gives ``n`` points (5), spaced
    geometrically when it spans a decade or more with positive ends (the lr
    and reg case), else linearly, unless "scale" says which."""
    axes = []
    for spec in tunable:
        name = spec["name"]
        if spec.get("type") == "choice":
            values = spec["values"]
        elif spec.get("type") == "range":
            lo, hi = spec["values"] if "values" in spec else (spec["min"], spec["max"])
            n = int(spec.get("n", 5))
            scale = spec.get("scale")
            if scale is None:
                scale = "log" if (lo > 0 and hi / lo >= 10) else "linear"
            if scale == "log":
                if lo <= 0:
                    raise ValueError(f"log-scale range needs positive endpoints: {spec}")
                values = [lo * (hi / lo) ** (i / max(n - 1, 1)) for i in range(n)]
            else:
                values = [lo + (hi - lo) * i / max(n - 1, 1) for i in range(n)]
        else:
            raise ValueError(f"Unknown tunable type {spec}")
        axes.append([(name, v) for v in values])
    return [dict(combo) for combo in itertools.product(*axes)]


_WORKER_PLACEMENT = None


def _init_worker(placement_queue):
    """Worker initializer: claim this worker's placement and apply its env
    before anything touches CUDA."""
    global _WORKER_PLACEMENT
    try:
        placement = placement_queue.get(timeout=30)
    except Exception:  # a respawned worker finds the queue empty: no placement
        placement = None
    _WORKER_PLACEMENT = placement
    if placement:
        for k, v in placement.get("env", {}).items():
            os.environ[k] = str(v)
        if placement.get("threads"):
            import torch

            torch.set_num_threads(int(placement["threads"]))


def _run_trial(spec):
    """One trial in a worker: the recommender rebuilt and trained."""
    import importlib

    import torch

    from ..config import Config

    cls_module, cls_name, cfg_raw, data, device = spec
    placement = _WORKER_PLACEMENT or {}
    device = placement.get("device", device)
    rec = getattr(importlib.import_module(cls_module), cls_name)(Config(cfg_raw), device=device)
    result = rec.train(data)
    cuda = torch.device(device).type == "cuda"
    return {
        "valid_metric": result["valid_metric"],
        "model_save_dir": result["model_save_dir"],
        "worker": {
            "pid": os.getpid(),
            "partition_index": placement.get("partition_index"),
            "n_devices": torch.cuda.device_count() if cuda else 1,
            "platform": "cuda" if cuda else "cpu",
        },
    }


def _worker_placements(processes, worker_env, device):
    """Each worker's placement, or None to run the trials in turn (one card
    and no ``worker_env``)."""
    import torch

    device = torch.device(device)
    if worker_env is not None:
        if len(worker_env) < processes:
            raise ValueError(f"worker_env has {len(worker_env)} entries for {processes} workers")
        return [{"env": dict(worker_env[i]), "partition_index": i} for i in range(processes)]
    if device.type == "cpu":
        threads = max((os.cpu_count() or 1) // processes, 1)
        return [{"device": "cpu", "threads": threads, "partition_index": i} for i in range(processes)]
    n_cards = torch.cuda.device_count()
    if n_cards <= 1:
        return None
    return [{"env": {"CUDA_VISIBLE_DEVICES": str(i % n_cards)}, "device": "cuda:0", "partition_index": i}
            for i in range(processes)]


def tune(recommender_cls, config, data, tune_dir=None, processes=0, worker_env=None, device=None):
    """Train every point of the config's grid; returns {"valid_metric",
    "model_save_dir", "tune_result"} of the best trial (``tune_result`` the
    table's rows) and writes tune_result.csv. ``device`` is the trials'
    device (CUDA when None: ``resolve_device``)."""
    from ..device import resolve_device

    device = str(resolve_device(device))
    grid = expand_grid(config.tunable)
    if not grid:
        raise ValueError("Config has no tunable section to tune over")
    trial_cfgs = [config.replace(model={**overrides, "tune": False}) for overrides in grid]
    placements = _worker_placements(processes, worker_env, device) if processes > 0 else None
    if processes > 0 and placements is None:
        print("WARNING: tune(processes>0) on a single card without worker_env — parallel workers would "
              "contend for the one card; running trials sequentially instead. "
              "For several cards pass worker_env=[{...per-worker env...}].")
        processes = 0
    if processes > 0:
        import concurrent.futures
        import multiprocessing as mp

        specs = [(recommender_cls.__module__, recommender_cls.__name__, cfg.to_dict(), data, device)
                 for cfg in trial_cfgs]
        ctx = mp.get_context("spawn")
        manager = ctx.Manager()  # hands each worker exactly one placement
        try:
            queue = manager.Queue()
            for placement in placements:
                queue.put(placement)
            with concurrent.futures.ProcessPoolExecutor(processes, mp_context=ctx, initializer=_init_worker,
                                                        initargs=(queue,)) as pool:
                results = list(pool.map(_run_trial, specs))
        finally:
            manager.shutdown()
    else:
        results = []
        for cfg in trial_cfgs:
            r = recommender_cls(cfg, device=device).train(data)
            results.append({"valid_metric": r["valid_metric"], "model_save_dir": r["model_save_dir"]})
    rows, best = [], None
    for i, (overrides, result) in enumerate(zip(grid, results)):
        row = {**overrides, "valid_metric": result["valid_metric"], "model_save_dir": result["model_save_dir"],
               "trial": i}
        for k, v in result.get("worker", {}).items():
            row[f"worker_{k}"] = v
        rows.append(row)
        if best is None or result["valid_metric"] > best["valid_metric"]:
            best = row
    out_dir = tune_dir or os.path.join(config.system.get("root_dir", "."),
                                       config.system.get("tune_dir", "tune_results/"))
    ensure_dir(out_dir)
    path = os.path.join(out_dir, "tune_result.csv")
    if os.path.exists(path):
        os.remove(path)  # one table a sweep, as pandas' to_csv writes it
    save_to_csv(rows, path)
    return {"valid_metric": best["valid_metric"], "model_save_dir": best["model_save_dir"], "tune_result": rows}
