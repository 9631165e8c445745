"""Sequence-dataset helpers: 1-based item reindexing, per-user sequences,
(prefix, target) expansion and padded batches (numpy only).

Counterpart of ``beta_recsys_tpu/datasets/seq_data_utils.py`` on frames of
numpy columns: items are renumbered 1..n in order of first appearance in
train (0 pads); each user's sequence is in stable timestamp order; every
position from the second on is a target with its whole prefix as input.
"""

import numpy as np

from ..utils.constants import DEFAULT_ITEM_COL, DEFAULT_TIMESTAMP_COL, DEFAULT_USER_COL
from .data_split import first_unique, groups, take


def reindex_items(train_data, valid_data=None, test_data=None):
    """Map item ids to 1..n (0 = padding) across splits, keyed on train's
    items in order of first appearance; rows of other items are dropped."""
    item2idx = {item: i + 1 for i, item in enumerate(first_unique(train_data[DEFAULT_ITEM_COL]).tolist())}

    def apply(frame):
        if frame is None:
            return None
        items = np.asarray(frame[DEFAULT_ITEM_COL])
        frame = take(frame, np.isin(items, list(item2idx)))
        frame[DEFAULT_ITEM_COL] = np.asarray([item2idx[i] for i in frame[DEFAULT_ITEM_COL].tolist()],
                                             dtype=np.int64)
        return frame

    out = [apply(train_data), apply(valid_data), apply(test_data)]
    return [d for d in out if d is not None] if (valid_data is not None or test_data is not None) else out[0]


def create_seq_db(data):
    """{"col_user": sorted users, "item_list": each user's items in stable
    timestamp order}."""
    ordered = take(data, np.argsort(np.asarray(data[DEFAULT_TIMESTAMP_COL]), kind="stable"))
    users, lists = [], []
    for user, rows in groups(ordered[DEFAULT_USER_COL]):
        users.append(user)
        lists.append(ordered[DEFAULT_ITEM_COL][rows].tolist())
    return {DEFAULT_USER_COL: np.asarray(users), "item_list": lists}


def dataset_to_seq_target_format(seq_db):
    """Every position >= 1 of each sequence as a target, its whole prefix as
    the input: (prefixes, targets)."""
    seqs, targets = [], []
    for items in seq_db["item_list"]:
        for t in range(1, len(items)):
            seqs.append(items[:t])
            targets.append(items[t])
    return seqs, targets


def pad_sequences(seqs, maxlen, pad_left=True):
    """Pad or cut (keeping the newest) sequences to (n, maxlen) int32."""
    out = np.zeros((len(seqs), maxlen), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[-maxlen:]
        if pad_left:
            out[i, maxlen - len(s):] = s
        else:
            out[i, :len(s)] = s
    return out


def collate_fn(batch, pad_left=False):
    """(seq, target) pairs padded to the batch's longest and sorted by
    descending length: (padded (B, L) int32, lengths, targets)."""
    seqs = [list(s) for s, _ in batch]
    targets = np.asarray([t for _, t in batch], dtype=np.int32)
    lengths = np.asarray([len(s) for s in seqs], dtype=np.int32)
    order = np.argsort(-lengths, kind="stable")
    maxlen = max(1, int(lengths.max()) if len(lengths) else 1)
    return pad_sequences([seqs[i] for i in order], maxlen, pad_left=pad_left), lengths[order], targets[order]


class SeqDataset:
    """(seq, target) examples padded to ``maxlen``, iterated in batches."""

    def __init__(self, seqs, targets, maxlen, pad_left=True):
        self.seq = pad_sequences(seqs, maxlen, pad_left)
        self.target = np.asarray(targets, dtype=np.int32)
        self.lengths = np.asarray([min(len(s), maxlen) for s in seqs], dtype=np.int32)

    def __len__(self):
        return len(self.target)

    def batches(self, batch_size, shuffle=True, rng=None):
        idx = np.arange(len(self))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(idx)
        for start in range(0, len(idx), batch_size):
            b = idx[start:start + batch_size]
            yield self.seq[b], self.target[b], self.lengths[b]
