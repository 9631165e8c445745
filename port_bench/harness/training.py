"""What the training drivers share: the weights' hand-over, the readings of
the checked first steps on both sides, and the faults a test plants.

The program's readings: each checked step's loss as the window's own call
returns it; each leaf's first gradient as its optimizer received it, worked
out from the optimizer's first moment after one step (m = (1 - b1) g); each
leaf's change over the checked steps, read before any later step. The
reference runs the same steps from the same weights and batches.
"""

import time

import torch

from harness import data
from harness.compare import training_numbers
from reference.adam import B1, adam, lazy_adam

CHECKED_STEPS = 3


def load_weights(model, weights):
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])


def norms(tensors):
    return {name: float(t.detach().double().norm()) for name, t in tensors.items()}


def first_gradients(model, moments, optimizer):
    """{leaf: its first gradient} from the optimizers' state after one
    step: ``moments`` {name: (m, v)} of the lazy-Adam tables, the rest from
    ``optimizer``'s ``exp_avg``."""
    grads = {}
    for name, p in model.named_parameters():
        # A step that never reached the optimizer leaves no state: no gradient.
        m = moments[name][0] if name in moments else optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
        grads[name] = m / (1 - B1)
    return grads


def changes(model, weights):
    return {name: p.detach() - weights[name] for name, p in model.named_parameters()}


def reference_steps(ref, model_cfg, weights, batches, lr, generator=None, tf32=False):
    """The reference's readings over ``batches`` (one a step) from
    ``weights``: {"losses", "grad_norms", "change_norms"}."""
    lazy = set(ref.lazy_tables(model_cfg))
    params = {k: w.detach().clone().requires_grad_(True) for k, w in weights.items()}
    state = {k: (torch.zeros_like(w), torch.zeros_like(w)) for k, w in weights.items()}
    losses, grad_norms, change_1 = [], None, None
    for step, batch in enumerate(batches, start=1):
        loss = ref.train_loss(model_cfg, params, batch, generator, tf32)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
        for k, p in params.items():
            (lazy_adam if k in lazy else adam)(p.data, grads[k], *state[k], step, lr)
        losses.append(float(loss.detach()))
        if step == 1:
            grad_norms = norms(grads)
            change_1 = norms({k: p.detach() - weights[k] for k, p in params.items()})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms_1": change_1,
            "change_norms": norms({k: p.detach() - weights[k] for k, p in params.items()})}


def plant(trainer, fault):
    """Break the trainer's step for a test or a fault's reading:
    "unchanged" returns a loss and changes nothing; "half_batch" trains on
    the first half of each batch, its mean over those rows alone."""
    if fault is None:
        return
    step = trainer.step
    if fault == "unchanged":
        trainer.step = lambda *args, **kwargs: torch.zeros((), device=trainer.device)
    elif fault == "half_batch":
        trainer.step = lambda *args, **kwargs: step(*(x[: x.shape[0] // 2] for x in args[:3]), *args[3:], **kwargs)
    else:
        raise ValueError(f"no fault {fault!r} for a training cell")


class TrainingDriver:
    """The part of a training driver (``harness/runner.py``'s protocol)
    that does not depend on the model: a subclass's ``setup`` makes the
    inputs, builds the program's trainer and calls ``start``. The window's
    call is the trainer's ``run_batches`` over one epoch's ``batches``
    ((steps, B, ...) tensors), the step's draws from ``generator``."""

    unit = None

    def __init__(self, cell, seed, device, fault=None):
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        self.cfg = cell.config["model"]
        self.ref = cell.reference()
        self.info = {"unit": self.unit}
        self.losses = []

    def weights(self):
        """The weights both sides start from, made on the card from the
        seed."""
        return self.ref.make_weights(self.cfg, self.n_users, self.n_items, data.generator(self.seed, self.device, 2),
                                     self.device)

    def start(self, trainer, batches, weights, moments, optimizer, generator=None):
        """Take the program's trainer, plant the fault if any, and run the
        ``CHECKED_STEPS`` first batches one ``run_batches`` call each,
        reading the loss, the first gradients (from ``moments`` {name: (m,
        v)} of lazy-Adam tables and ``optimizer``'s state) and the
        changes."""
        self.trainer, self.batches, self.generator = trainer, batches, generator
        self.gen_state = None if generator is None else generator.get_state()
        plant(trainer, self.fault)
        model, losses = trainer.model, []
        for b in range(CHECKED_STEPS):
            losses.append(float(trainer.run_batches(*(x[b:b + 1] for x in batches), generator=generator)))
            if b == 0:
                grad_norms = norms(first_gradients(model, moments, optimizer))
                change_1 = norms(changes(model, weights))
        self.program = {"losses": losses, "grad_norms": grad_norms, "change_norms_1": change_1,
                        "change_norms": norms(changes(model, weights))}
        self.info["steps_per_call"] = batches[0].shape[0]

    def call(self):
        self.losses.append(self.trainer.run_batches(*self.batches, generator=self.generator))
        return self.batches[0].numel()

    def outcome(self):
        steps = self.batches[0].shape[0]
        return len(self.losses) * steps, int((~torch.isfinite(torch.stack(self.losses))).sum()) * steps

    def profiled(self, n):
        from torch.profiler import record_function

        n = min(n, self.batches[0].shape[0])
        for b in range(n):
            with record_function(f"{type(self.trainer).__name__}.run_batches"):
                self.trainer.run_batches(*(x[b:b + 1] for x in self.batches), generator=self.generator)
        self.info["profiled_batches"] = list(range(n))
        return n

    def dispatch(self, n):
        out = []
        for b in range(min(n, self.batches[0].shape[0])):
            _sync(self.device)
            t0 = time.perf_counter()
            self.trainer.step(*(x[b] for x in self.batches), self.generator)
            out.append(time.perf_counter() - t0)
        _sync(self.device)
        return out

    def release(self):
        del self.trainer, self.batches
        self.losses = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reading(self, tf32=False):
        """The reference's readings of the checked steps (``self.checked``,
        the batches as the model's loss takes them), from the weights made
        again from the seed and the generator's state before the first
        checked step; with ``tf32`` the control's."""
        gen = None
        if self.gen_state is not None:
            gen = torch.Generator(device=self.device)
            gen.set_state(self.gen_state)
        return reference_steps(self.ref, self.cfg, self.weights(), self.checked, float(self.cfg["lr"]),
                               generator=gen, tf32=tf32)

    numbers = staticmethod(training_numbers)

    def verify(self):
        return self.numbers(self.program, self.reading())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
