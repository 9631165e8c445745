"""Walker's alias method over label frequencies (numpy only).

Counterpart of ``AliasTable`` in ``beta_recsys_tpu/utils/alias_table.py``
(the reference's ``beta_rec/utils/alias_table.py``): the same ``vocab_size``,
``prob_arr``, ``alias_arr``, ``index2Label`` and ``sample(count, obj_num,
no_repeat)``. The construction pops the small and large work lists in LIFO
order, so the tables equal the JAX package's bit for bit for the same
frequencies. The trainers draw from the tables on the device
(``ops/sampling.alias_negatives``); ``sample`` is the host draw.
"""

import numpy as np


class AliasTable:
    """O(1)-per-draw discrete sampler using Walker's alias method."""

    def __init__(self, obj_freq):
        if isinstance(obj_freq, list):
            freqs = np.asarray(obj_freq, dtype=np.float64)
            if freqs.ndim != 1:
                raise ValueError("Error: obj_freq is not 1-dim")
            labels = list(range(len(freqs)))
        elif isinstance(obj_freq, dict):
            labels = list(obj_freq.keys())
            freqs = np.asarray(list(obj_freq.values()), dtype=np.float64)
        else:
            raise ValueError("Error: obj_freq is invalid")

        n = len(freqs)
        self.vocab_size = n
        self.index2Label = labels

        scaled = freqs * (n / freqs.sum())  # prob * table_size
        prob_arr = scaled.copy()
        alias_arr = np.zeros(n, dtype=np.int64)

        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] >= 1.0]
        while small and large:
            s = small.pop()
            l = large.pop()  # noqa: E741
            alias_arr[s] = l
            prob_arr[l] -= 1.0 - prob_arr[s]
            (small if prob_arr[l] < 1.0 else large).append(l)

        self.prob_arr = prob_arr
        self.alias_arr = alias_arr

    def _draw(self, count):
        """``count`` labels drawn with replacement."""
        idx = np.asarray(np.random.randint(low=0, high=len(self.prob_arr), size=count))
        u = np.asarray([np.random.uniform() for _ in range(len(idx))]) \
            if count <= 8 else np.random.uniform(size=len(idx))
        chosen = np.where(u >= self.prob_arr[idx], self.alias_arr[idx], idx)
        return [self.index2Label[i] for i in chosen]

    def sample(self, count, obj_num=1, no_repeat=False):
        """``obj_num`` lists of ``count`` labels (one list when ``obj_num`` is
        1); with ``no_repeat`` each list holds distinct labels, redrawn until
        full, which needs ``count <= vocab_size``."""
        draws = []
        for _ in range(obj_num):
            samples = self._draw(count)
            if no_repeat:
                if count > self.vocab_size:
                    raise ValueError("Error: count>vocab_size!! Skip no_repeat parameter")
                uniq = set(samples)
                while len(uniq) < count:
                    uniq |= set(self._draw(max(count - len(uniq), 1)))
                samples = list(uniq)[:count]
            if obj_num == 1:
                return samples
            draws.append(samples)
        return draws
