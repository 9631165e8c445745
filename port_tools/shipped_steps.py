#!/usr/bin/env python3
"""Per-step losses of SASRec at configs/sasrec_default.json's shapes (maxlen
200, lr 0.5) for one checkout of the port, through three attention paths.

    python3 port_tools/shipped_steps.py <checkout root> <label>

Needs a GPU. Imports ``beta_recsys_tpu_torch`` from ``<checkout root>``
(building its kernels there) and ``chip_smoke.py`` from this checkout for
the MovieLens-1M-shaped data (seed 0). Runs 21 training steps, one step a
``run_batches`` call, for each path at the config's dropout rate (0.1) and
at rate 0:

- ``kernels``: ``fused_attention`` true, the flash kernels forward and
  backward;
- ``plain flash``: the same autograd function with the kernels' plain
  versions on the card (``flash_causal_attention_reference`` and
  ``flash_causal_attention_bwd_reference``: the same Philox masks, the
  backward's probabilities recomputed from the forward's lse);
- ``autograd``: ``fused_attention`` false, the plain forward and autograd
  through its softmax (no lse in the backward).

The three draw the same dropout masks from one seed, so they can be held
step by step. Prints one JSON line a run: the label, the path, the rate,
every step's loss, the largest |lse| of each step (plain flash only) and
the largest parameter magnitude after the last step.

To compare two commits on one card, unpack the parent with ``git archive``
into a directory ``.gitignore`` lists and run both in one call.
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.abspath(sys.argv[1]))
import beta_recsys_tpu_torch  # noqa: E402,F401  (the checkout's package, before chip_smoke's path)

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from beta_recsys_tpu_torch.data.sequential_data import SequentialData  # noqa: E402
from beta_recsys_tpu_torch.ops import attention  # noqa: E402
from beta_recsys_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    FlashCausalAttention,
    flash_causal_attention_bwd_reference,
    flash_causal_attention_reference,
)

STEPS = 21
LSE_MAX = []  # the largest |lse| of each plain flash forward


class PlainFlash(torch.autograd.Function):
    """FlashCausalAttention with the kernels' plain versions on any device."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate):
        out, lse = flash_causal_attention_reference(q, k, v, rate, seed)
        LSE_MAX.append(float(lse.abs().max()))
        ctx.save_for_backward(q, k, v, lse, seed)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, seed = ctx.saved_tensors
        dq, dk, dv = flash_causal_attention_bwd_reference(q, k, v, lse, dout.contiguous(), ctx.rate, seed)
        return dq, dk, dv, None, None


def run(data, path, rate):
    attention.FlashCausalAttention = PlainFlash if path == "plain flash" else FlashCausalAttention
    LSE_MAX.clear()
    cfg = cs.load_config(cs.DEFAULT_CONFIG).replace(
        system={"root_dir": tempfile.mkdtemp(), "seed": 0},
        model={"fused_attention": path != "autograd", "dropout_rate": rate})
    model = cs.build_model(cfg.model, data.n_users, data.n_items, device=torch.device("cuda"))
    engine = cs.TrainEngine(cfg, torch.device("cuda")).build(model, data)
    trainer = engine.epoch_fn
    rows, users, neg = trainer.form(engine.generator)
    losses, lse = [], []
    for i in range(STEPS):
        before = len(LSE_MAX)
        losses.append(float(trainer.run_batches(rows[i:i + 1], users[i:i + 1], neg[i:i + 1],
                                                generator=engine.generator)))
        lse.append(max(LSE_MAX[before:], default=None))
    largest = max(float(p.detach().abs().max()) for p in model.parameters())
    return {"path": path, "rate": rate, "losses": losses, "max_abs_lse": lse if path == "plain flash" else None,
            "max_param": largest}


def main():
    label = sys.argv[2]
    cs.fp32_matmuls()
    data = SequentialData(cs.ml1m_shaped_split(0))
    for rate in (0.1, 0.0):
        for path in ("kernels", "plain flash", "autograd"):
            print(json.dumps({"label": label, **run(data, path, rate)}), flush=True)


if __name__ == "__main__":
    main()
