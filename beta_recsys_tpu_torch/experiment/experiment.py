"""Experiment: every model on every dataset, one results table.

Counterpart of ``beta_recsys_tpu/experiment/experiment.py``: the metric, k
and result-file overrides go into every model's config (a new frozen
``Config`` through ``replace``), each (dataset, model) pair is trained and
tested, and the rows collate into one table, a list of dicts (no pandas).
"""


class Experiment:
    """Train and test every model on every dataset."""

    def __init__(self, datasets, models, metrics=None, eval_scopes=None, result_file=None, save_dir=None):
        self.datasets = datasets
        self.models = models
        self.metrics = metrics
        self.eval_scopes = eval_scopes
        self.result_file = result_file
        self.save_dir = save_dir
        self.results = None
        self._update_configs()

    def _update_configs(self):
        overrides = {}
        if self.metrics is not None:
            overrides["metrics"] = list(self.metrics)
        if self.eval_scopes is not None:
            overrides["k"] = list(self.eval_scopes)
        if self.save_dir is not None:
            overrides["result_dir"] = self.save_dir
        for idx, model in enumerate(self.models):
            per_model = dict(overrides)
            if self.result_file is not None:
                name = model.config.model.get("model", f"model_{idx}")
                per_model["result_file"] = f"model_{idx}_{name}_{self.result_file}"
            if per_model:
                model.config = model.config.replace(system=per_model)

    def load_pretrained_model(self, model_dir):
        """Load each model from a checkpoint directory and test it on each
        dataset, with no training; the test rows."""
        rows = []
        for data in self.datasets:
            for model in self.models:
                model.load(model_dir, data=data)
                rows.append(model.test())
        return rows

    def run(self):
        """Train and test the whole matrix; the rows, printed as a table."""
        rows = []
        for data in self.datasets:
            for model in self.models:
                train_result = model.train(data)
                rows.append({"model": model.config.model.get("model"),
                             "dataset": model.config.dataset.get("dataset"),
                             "valid_metric": train_result.get("valid_metric"), **model.test()})
        self.results = rows
        columns = list(dict.fromkeys(k for row in rows for k in row))
        print("  ".join(columns))
        for row in rows:
            print("  ".join(str(row.get(c, "")) for c in columns))
        return rows
