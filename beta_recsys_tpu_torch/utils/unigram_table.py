"""A word2vec-style unigram sampler: labels drawn with probability
proportional to count ** 0.75.

Counterpart of ``beta_recsys_tpu/utils/unigram_table.py``, with the same
table (each label repeated round(p * size) times, at least once; size
max(100 labels, 1e6) capped at 1e8). ``sample`` takes its numpy generator:
a ``RandomState`` (``randint``, the draws of the JAX version's global
``np.random``) or a ``Generator`` (``integers``).
"""

import numpy as np

TABLE_CAP = int(1e8)


class UnigramTable:
    """Sampler over labels with probability proportional to count ** power."""

    def __init__(self, obj_freq, power=0.75, table_size=None):
        if isinstance(obj_freq, dict):
            labels = np.asarray(list(obj_freq.keys()))
            freqs = np.asarray(list(obj_freq.values()), dtype=np.float64)
        else:
            freqs = np.asarray(obj_freq, dtype=np.float64)
            labels = np.arange(len(freqs))
        self.labels = labels
        pow_freq = freqs ** power
        norm = pow_freq / pow_freq.sum()
        if table_size is None:
            table_size = min(max(len(freqs) * 100, 1_000_000), TABLE_CAP)
        counts = np.maximum(np.round(norm * table_size).astype(np.int64), 1)
        self.table = np.repeat(np.arange(len(labels)), counts)

    def sample(self, count, rng):
        """``count`` labels drawn with replacement by ``rng``."""
        draw = rng.integers if isinstance(rng, np.random.Generator) else rng.randint
        return self.labels[self.table[draw(0, len(self.table), size=count)]]
