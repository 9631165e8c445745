#!/usr/bin/env python3
"""How far TiSASRec's first Adam steps move under float32 rounding, on the CPU,
and what the structured split's time intervals hold.

    python3 port_tools/tisasrec_sensitivity.py

Builds TiSASRec at its shipped config on the structured split on the CPU
(``chip_smoke.seq_engine``), forms one epoch's batches and runs 5 Adam steps
from the initial weights twice: as they are, and multiplied elementwise by
1 + 1e-7 * N(0, 1) (a float32 rounding's worth), the second run handed the
first's dropout masks (``chip_smoke.DrawReplay``). It does so once with the
FFN's ReLU decisions handed over too and once without, and prints after
each step the largest parameter and gradient differences and how many
elements differ by more than 1e-5. Then, from the unperturbed run's state
before each step, it prints how far that step's float32 gradients lie from
float64 ones on the same batch and masks. It is the measurement behind
``chip_smoke.DrawReplay``'s ReLU decisions (PERF.md section 6). Last, it
prints the split's timestamps: their range, the median of each user's
smallest nonzero gap (TiSASRec's time scale), and the share of a training
row's intervals between real items that reach ``time_span``. ~2 minutes
on 4 threads.
"""

import numpy as np

import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

STEPS = 5


class OwnReluDecisions(cs.DrawReplay):
    """``DrawReplay`` without the ReLU decisions: each run takes its own."""

    def __enter__(self):
        super().__enter__()
        for module, name, real in self._saved:
            if name == "relu":
                setattr(module, name, real)
        return self


def perturbed_runs(data, root, relu_replay):
    _, a = cs.seq_engine("TiSASRec", 0, root, data, "cpu")
    _, b = cs.seq_engine("TiSASRec", 0, root, data, "cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
            q.copy_(p * (1 + 1e-7 * torch.randn(p.shape, generator=g)))
    batches = [x[:STEPS] for x in a.epoch_fn.form(a.generator)]
    with (cs.DrawReplay if relu_replay else OwnReluDecisions)() as replay:
        for s in range(STEPS):
            replay.replaying = False
            la = float(a.epoch_fn.run_batches(*(x[s:s + 1] for x in batches), generator=a.generator))
            replay.replaying = True
            lb = float(b.epoch_fn.run_batches(*(x[s:s + 1] for x in batches), generator=b.generator))
            pa, pb = ({n: p.detach() for n, p in m.model.named_parameters()} for m in (a, b))
            grads = [{n: p.grad for n, p in m.model.named_parameters()} for m in (a, b)]
            d_param = max((float((pa[n] - pb[n]).abs().max()), n) for n in pa)
            d_grad = max((float((grads[0][n] - grads[1][n]).abs().max()), n) for n in pa)
            past = sum(int(((pa[n] - pb[n]).abs() > 1e-5).sum()) for n in pa)
            print(f"relu decisions {'handed over' if relu_replay else 'own'}, step {s}: loss {la:.7f} / {lb:.7f}; "
                  f"parameters max |d| {d_param[0]:.3g} ({d_param[1]}), {past} elements > 1e-5; gradients max |d| "
                  f"{d_grad[0]:.3g} ({d_grad[1]})", flush=True)


def float64_gradients(data, root):
    _, a = cs.seq_engine("TiSASRec", 0, root, data, "cpu")
    batches = [x[:STEPS] for x in a.epoch_fn.form(a.generator)]
    with cs.DrawReplay() as replay:
        for s in range(STEPS):
            state, gen = {k: v.clone() for k, v in a.model.state_dict().items()}, a.generator.get_state()
            replay.replaying = False
            batch = a.epoch_fn.batch(*(x[s] for x in batches))
            a.model.zero_grad(set_to_none=True)
            a.model.loss(batch, a.generator).backward()
            ref = type(a.model)(a.model.config, a.model.n_users, a.model.n_items, device="cpu").double()
            ref.load_state_dict({k: v.double() for k, v in state.items()})
            replay.replaying = True
            ref.loss(batch, a.generator).backward()
            worst = max((float((p.grad - dict(a.model.named_parameters())[n].grad.double()).abs().max()), n)
                        for n, p in ref.named_parameters())
            print(f"step {s}: float32 gradients within {worst[0]:.3g} of float64 ({worst[1]})", flush=True)
            a.generator.set_state(gen)  # the real step draws the same masks again
            replay.replaying = False
            a.epoch_fn.run_batches(*(x[s:s + 1] for x in batches), generator=a.generator)
            replay.queue.clear()


def timestamps(data):
    span = int(cs.load_config(os.path.join(cs.REPO, cs.SEQ_FAMILY["TiSASRec"][1])).model.time_span)
    users, _, stamps = data._train_events(with_times=True)
    gaps = [np.diff(stamps[users == u]) for u in range(data.n_users)]
    scales = [g[g > 0].min() if (g > 0).any() else 1 for g in gaps]
    arrays = data.tisasrec_arrays(50, span)
    real = (arrays["seq"][:, :, None] != 0) & (arrays["seq"][:, None, :] != 0)
    print(f"timestamps {stamps.min()}-{stamps.max()} over {len(stamps)} train rows; median smallest gap a user "
          f"{np.median(scales):g}; intervals between real items at the clip {span}: "
          f"{(arrays['time_matrix'][real] == span).mean():.4f}", flush=True)


def main():
    torch.set_num_threads(4)
    data = cs.seq_split()
    timestamps(data)
    with tempfile.TemporaryDirectory() as root:
        for relu_replay in (False, True):
            perturbed_runs(data, root, relu_replay)
        float64_gradients(data, root)


if __name__ == "__main__":
    main()
