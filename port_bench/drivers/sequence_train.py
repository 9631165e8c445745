"""Sequence training (SASRec) through the port's ``SequenceEpochTrainer``
(``core/train_engine.py``), each step through its one-device
``DataParallelStep`` (``parallel/data_parallel.py``): loss, backward, Adam.

Set-up makes the configuration's log and the training arrays (each user's
train sequence, the last ``maxlen`` items), and draws from the seed one
epoch's batches (``n_users // batch_size`` batches of distinct users, a
permutation's first rows, where the trainer's own ``form`` draws rows with
replacement: the padding an epoch carries then varies little from seed to
seed; one negative a position rejected against the user's train positives)
and the weights, all on the device; builds the model and the trainer
as the training engine builds them; and trains the first checked batches
one ``run_batches`` call each, the dropout drawn from the run's generator.
The window replays the epoch's batches, one ``run_batches`` call an epoch,
drawing dropout as it goes. Work units: the sequences trained.
"""

import torch

from harness import data
from harness.training import CHECKED_STEPS, TrainingDriver, load_weights


class Driver(TrainingDriver):
    unit = "sequences"

    def setup(self):
        from beta_recsys_tpu_torch.core.train_engine import SequenceEpochTrainer, make_optimizer
        from beta_recsys_tpu_torch.models import build_model

        dev, B = self.device, int(self.cell.traffic["batch_size"])
        maxlen = int(self.cfg["maxlen"])
        split = data.interactions(self.cell.config["data"], dev)
        self.n_users, self.n_items = split.n_users, split.n_items
        arrays = data.sequences(split, maxlen)
        keys = split.train_keys()
        del split
        steps = max(self.n_users // B, 1)
        g = data.generator(self.seed, dev, 1)
        rows = torch.randperm(self.n_users, generator=g, device=dev)[: steps * B].view(steps, B)
        users = arrays["users"][rows]
        neg0 = data.rejection_negatives(g, users[..., None].expand(-1, -1, maxlen), self.n_items, keys)
        del keys

        weights = self.weights()
        model = build_model(self.cfg, self.n_users, self.n_items, device=dev)
        load_weights(model, weights)
        trainer = SequenceEpochTrainer(model, make_optimizer(self.cfg, model.parameters()), arrays, B, None)
        self.start(trainer, (rows, users, neg0), weights, {}, trainer.optimizer, data.generator(self.seed, dev, 3))
        self.checked = []
        for b in range(CHECKED_STEPS):
            pos = arrays["pos"][rows[b]]
            self.checked.append({"seq": arrays["seq"][rows[b]], "pos": pos, "neg": torch.where(pos != 0, neg0[b] + 1, 0)})
        heads, d, blocks = int(self.cfg["num_heads"]), int(self.cfg["emb_dim"]), int(self.cfg["num_blocks"])
        self.info.update(batch_size=B, flash=[(B * heads, maxlen, d // heads)] * blocks,
                         step_flops=3 * self.ref.forward_flops(self.cfg, B) + 3 * 2 * 2 * B * maxlen * d)
