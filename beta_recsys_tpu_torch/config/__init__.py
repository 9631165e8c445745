"""Four-section run configuration over the JSON configs (``system`` /
``dataset`` / ``model`` / ``tunable``).

Counterpart of ``beta_recsys_tpu/config/__init__.py``, the same schema and the
same frozen semantics: derived artifacts go to models explicitly, never into
the config. ``load_config`` also reads the config a training run stored in a
checkpoint directory's ``metadata.json``.
"""

import copy
import json
import os

_CONFIG_SEARCH_DIRS = [
    os.getcwd(),
    os.path.join(os.getcwd(), "configs"),
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "configs"),
]


class ConfigSection:
    """Read-only attribute/dict view over one config section."""

    def __init__(self, data):
        object.__setattr__(self, "_data", dict(data))

    def __getattr__(self, key):
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __getitem__(self, key):
        return self._data[key]

    def __contains__(self, key):
        return key in self._data

    def __setattr__(self, key, value):
        raise AttributeError("Config sections are immutable; pass derived artifacts explicitly")

    def __copy__(self):
        return self  # immutable: a copy may share it (a model's replica on another card does)

    def __deepcopy__(self, memo):
        return self

    def get(self, key, default=None):
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self):
        return copy.deepcopy(self._data)

    def replace(self, **kwargs):
        """Return a new section with the given keys replaced/added."""
        data = dict(self._data)
        data.update(kwargs)
        return ConfigSection(data)

    def __repr__(self):
        return f"ConfigSection({self._data!r})"


class Config:
    """Frozen four-section run configuration."""

    SECTIONS = ("system", "dataset", "model", "tunable")

    # flat-legacy key routing (reference configs/cmn_default.json has no
    # system/dataset/model sections — everything at top level)
    _FLAT_SYSTEM_KEYS = frozenset({
        "root_dir", "log_dir", "result_dir", "checkpoint_dir", "dataset_dir",
        "process_dir", "pretrain_dir", "run_dir", "tune_dir", "device",
        "seed", "metrics", "k", "valid_metric", "validate_metric", "valid_k",
        "result_file", "save_mode",
    })
    _FLAT_DATASET_KEYS = frozenset({
        "dataset", "data_split", "download", "random", "test_rate", "by_user",
        "n_test", "n_negative", "percent",
    })

    @classmethod
    def _sectionize_flat(cls, raw):
        """Route a reference flat-legacy config into the four sections."""
        out = {"system": {}, "dataset": {}, "model": {}, "tunable": raw.get("tunable", [])}
        for k, v in raw.items():
            if k == "tunable":
                continue
            if k in cls._FLAT_SYSTEM_KEYS:
                out["system"][k] = v
            elif k in cls._FLAT_DATASET_KEYS:
                out["dataset"][k] = v
            else:
                out["model"][k] = v
        return out

    def __init__(self, raw):
        raw = copy.deepcopy(raw)
        has_sectioned_key = any(
            isinstance(raw.get(s), dict) for s in ("system", "dataset", "model")
        )
        flat_marker = not isinstance(raw.get("model", {}), dict) or not isinstance(
            raw.get("dataset", {}), dict
        )
        # flat-legacy if 'model'/'dataset' appear as scalars, OR if no section
        # appears as a dict at all (a flat config naming neither key would
        # otherwise silently parse into four empty sections)
        if flat_marker or (raw and not has_sectioned_key):
            raw = self._sectionize_flat(raw)
        object.__setattr__(self, "system", ConfigSection(raw.get("system", {})))
        object.__setattr__(self, "dataset", ConfigSection(raw.get("dataset", {})))
        object.__setattr__(self, "model", ConfigSection(raw.get("model", {})))
        object.__setattr__(self, "tunable", tuple(raw.get("tunable", []) or ()))

    def __setattr__(self, key, value):
        raise AttributeError("Config is immutable")

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        # without this, `"dataset" in config` falls back to integer-index
        # iteration via __getitem__ and raises TypeError. Also search the
        # section dicts so reference-style `"test_rate" in config` membership
        # tests keep their flat-dict semantics.
        if key in self.SECTIONS:
            return True
        return any(key in getattr(self, s) for s in ("system", "dataset", "model"))

    def to_dict(self):
        return {
            "system": self.system.to_dict(),
            "dataset": self.dataset.to_dict(),
            "model": self.model.to_dict(),
            "tunable": [dict(t) for t in self.tunable],
        }

    def replace(self, **section_updates):
        """Return a new Config with per-section key updates.

        ``cfg.replace(model={"lr": 0.1})`` merges into the model section.
        """
        raw = self.to_dict()
        for section, updates in section_updates.items():
            if section == "tunable":
                raw["tunable"] = updates
            else:
                raw[section].update(updates)
        return Config(raw)

    def __repr__(self):
        return f"Config(model={self.model.get('model')}, dataset={self.dataset.get('dataset')})"


def find_config(config_path):
    """Locate a config file: absolute path, cwd, ./configs, or packaged configs.

    Reference semantics: beta_rec/core/config.py:5-22.
    """
    if os.path.isfile(config_path):
        return config_path
    name = os.path.basename(config_path)
    for d in _CONFIG_SEARCH_DIRS:
        candidate = os.path.join(d, name)
        if os.path.isfile(candidate):
            return candidate
    raise FileNotFoundError(f"Config file not found: {config_path}")


def load_config(config_path, overrides=None):
    """Load a JSON config + apply flat overrides (matching key in any section).

    ``config_path`` may also be a checkpoint directory: its ``metadata.json``
    holds the run's config under ``"config"``.
    """
    if os.path.isdir(config_path):
        with open(os.path.join(config_path, "metadata.json")) as f:
            raw = json.load(f)["config"]
    else:
        with open(find_config(config_path)) as f:
            raw = json.load(f)
    if overrides:
        for k, v in overrides.items():
            if v is None:
                continue
            placed = False
            for section in ("system", "dataset", "model"):
                if section in raw and k in raw[section]:
                    raw[section][k] = v
                    placed = True
            if not placed:
                raw.setdefault("model", {})[k] = v
    return Config(raw)
