"""The benchmark's device generator of MovieLens-shaped logs: the shape it
promises, and the sequence layouts the port's own data classes build from
the same log."""

import numpy as np
import torch

from harness import data

SHAPE = {"seed": 3, "n_users": 50, "n_items": 40, "n_interactions": 1300, "min_per_user": 20, "max_per_user": 35,
         "count_sigma": 1.2, "popularity_exponent": 0.8, "popularity_offset": 10}


def test_the_split_keeps_the_shape_and_every_draw_the_same_counts():
    a = data.interactions(SHAPE, torch.device("cpu"))
    b = data.interactions({**SHAPE, "seed": 2**40 + 11}, torch.device("cpu"))
    counts = torch.bincount(a.users, minlength=SHAPE["n_users"])
    assert torch.equal(counts, a.counts) and int(counts.sum()) == SHAPE["n_interactions"]
    assert int(counts.min()) >= 20 and int(counts.max()) <= 35
    assert torch.equal(torch.sort(a.counts).values, torch.sort(b.counts).values)
    pairs = a.users * SHAPE["n_items"] + a.items
    assert torch.unique(pairs).numel() == pairs.numel()
    for part in ("valid", "test"):
        users, _ = a.part(part)
        assert torch.equal(users, torch.arange(SHAPE["n_users"]))
    users, items = a.part("train")
    neg = data.rejection_negatives(torch.Generator().manual_seed(0), users, SHAPE["n_items"], a.train_keys())
    assert not data.is_positive(a.train_keys(), users, neg, SHAPE["n_items"]).any()


def test_sequences_and_context_are_the_ports_layouts():
    from beta_recsys_tpu_torch.data.sequential_data import SequentialData
    from beta_recsys_tpu_torch.utils.constants import (DEFAULT_ITEM_COL, DEFAULT_RATING_COL, DEFAULT_TIMESTAMP_COL,
                                                       DEFAULT_USER_COL)

    split = data.interactions(SHAPE, torch.device("cpu"))
    maxlen = 24
    stamp = torch.arange(split.users.shape[0])

    def frame(sel):
        return {DEFAULT_USER_COL: split.users[sel].numpy(), DEFAULT_ITEM_COL: split.items[sel].numpy(),
                DEFAULT_RATING_COL: np.ones(int(sel.sum()), np.float32), DEFAULT_TIMESTAMP_COL: stamp[sel].numpy()}

    port = SequentialData((frame(split.from_end > 2), [frame(split.from_end == 2)], [frame(split.from_end == 1)]))
    user_of, item_of = np.asarray(port.user_pool), np.concatenate([[0], np.asarray(port.item_pool) + 1])
    arrays = port.train_seq_arrays(maxlen)
    ours = data.sequences(split, maxlen)
    rows = user_of[arrays["users"]]
    for key in ("seq", "pos"):
        assert np.array_equal(item_of[arrays[key]], ours[key].numpy()[rows])
    ctx = port.eval_context(maxlen)
    assert np.array_equal(item_of[ctx], data.context(split, maxlen).numpy()[user_of])
