"""Pairwise (BPR) training of a model with row tables through the port's
lazy-Adam trainer, ``core/sparse_optim.py`` ``SparseEpochTrainer``.

Set-up makes the configuration's log and draws from the seed one epoch's
batches (a permutation of the train positives wrapped to whole batches of
``batch_size``, and one negative a positive drawn uniformly and rejected
against the user's train positives) and the weights, all on the device; builds the model and the
trainer as the training engine builds them for ``"sparse_optim": true``;
and trains the first checked batches one ``run_batches`` call each. The
window replays the epoch's batches, one ``run_batches`` call an epoch.
Work units: the positives trained.
"""

from types import SimpleNamespace

import torch

from harness import data
from harness.training import CHECKED_STEPS, TrainingDriver, load_weights


class Driver(TrainingDriver):
    unit = "examples"

    def setup(self):
        from beta_recsys_tpu_torch.core.sparse_optim import SparseEpochTrainer
        from beta_recsys_tpu_torch.core.train_engine import make_optimizer
        from beta_recsys_tpu_torch.models import build_model

        dev, B = self.device, int(self.cell.traffic["batch_size"])
        split = data.interactions(self.cell.config["data"], dev)
        self.n_users, self.n_items = split.n_users, split.n_items
        users, items = split.part("train")
        keys = split.train_keys()
        del split
        n = users.shape[0]
        steps = -(-n // B)
        g = data.generator(self.seed, dev, 1)
        order = torch.randperm(n, generator=g, device=dev).repeat(2)[: steps * B]
        U, P = users[order].view(steps, B), items[order].view(steps, B)
        N = data.rejection_negatives(g, U, self.n_items, keys)
        del keys, order

        weights = self.weights()
        model = build_model(self.cfg, self.n_users, self.n_items, device=dev)
        load_weights(model, weights)
        tables = model.row_tables()
        dense = make_optimizer(self.cfg, [p for k, p in model.named_parameters() if k not in tables])
        trainer = SparseEpochTrainer(model, SimpleNamespace(users=users, items=items), B, None,
                                     lr=float(self.cfg["lr"]), dense_optimizer=dense,
                                     row_update=self.cfg.get("row_update", "auto"))
        del users, items
        self.start(trainer, (U, P, N), weights, trainer.state["moments"], dense)
        self.checked = [{"users": U[b], "pos": P[b], "neg": N[b]} for b in range(CHECKED_STEPS)]
        touched = [(torch.unique(U[b]).numel(), torch.unique(torch.cat([P[b], N[b]])).numel()) for b in range(steps)]
        self.info.update(batch_size=B, emb_dim=int(self.cfg["emb_dim"]), touched=touched)
