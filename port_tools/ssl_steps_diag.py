#!/usr/bin/env python3
"""Card against CPU, step by step, for SimGCL, SGL, BUIR and LCFN.

    python3 port_tools/ssl_steps_diag.py [SGL] [BUIR] [LCFN] [SimGCL]

On a machine with a card: builds each model at its capped shipped config
(``chip_smoke.ssl_engine``) on the card and on the CPU from the same
weights, runs 5 Adam steps on the same batches and draws
(``chip_smoke.DrawReplay``), and prints for each step the two losses and,
for each parameter, the largest gradient difference beside the largest
gradient, the largest parameter difference, where it lies, the two
gradients there, and how many elements differ by more than 1e-5. It is
the diagnosis behind ``chip_smoke.SSL_EPS_SET`` (PERF.md §6).
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main():
    print(cs.nvidia_smi_line(), flush=True)
    cs.fp32_matmuls()
    data = cs.mf_split()
    root = tempfile.mkdtemp()
    for name in sys.argv[1:] or list(cs.SSL_FAMILY):
        _, card = cs.ssl_engine(name, 0, root, data)
        _, cpu = cs.ssl_engine(name, 0, root, data, "cpu")
        cpu.model.load_state_dict(card.model.state_dict())
        batches = [x[:5] for x in card.epoch_fn.form(card.generator)]
        with cs.DrawReplay() as replay:
            for step in range(5):
                replay.replaying = False
                loss = float(card.epoch_fn.run_batches(*(x[step:step + 1] for x in batches), generator=card.generator))
                grads = {n: p.grad.detach().cpu().clone() for n, p in card.model.named_parameters()
                         if p.grad is not None}
                replay.replaying = True
                cpu_loss = float(cpu.epoch_fn.run_batches(*(x[step:step + 1] for x in batches),
                                                          generator=cpu.generator))
                out = [f"{name} step {step}: loss {loss:.6f} cpu {cpu_loss:.6f}"]
                on_cpu = dict(cpu.model.named_parameters())
                for n, p in card.model.named_parameters():
                    if n not in grads:
                        continue
                    g, g_cpu = grads[n], on_cpu[n].grad
                    d = (p.detach().cpu() - on_cpu[n].detach()).abs()
                    i = int(d.argmax())
                    at = divmod(i, d.shape[1]) if d.dim() == 2 else (i,)
                    out.append(f"  {n}: grad max|d| {float((g - g_cpu).abs().max()):.3g} (max|g| "
                               f"{float(g.abs().max()):.3g}); param max|d| {float(d.max()):.3g} at {at}, grad there "
                               f"{float(g[at]):.3g} vs cpu {float(g_cpu[at]):.3g}; elements > 1e-5: "
                               f"{int((d > 1e-5).sum())}")
                print("\n".join(out), flush=True)


if __name__ == "__main__":
    main()
