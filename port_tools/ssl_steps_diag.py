#!/usr/bin/env python3
"""Card against CPU, step by step, for SimGCL, SGL, BUIR, LCFN and TiSASRec.

    python3 port_tools/ssl_steps_diag.py [--resync] [SGL] [BUIR] [LCFN] [SimGCL] [TiSASRec]

On a machine with a card: builds each model at its capped shipped config
(``chip_smoke.ssl_engine`` or ``seq_engine``) on the card and on the CPU
from the same weights, runs 5 Adam steps on the same batches and draws
(``chip_smoke.DrawReplay``: also the dropout masks), and prints for each
step the two losses and, for each parameter, the largest gradient
difference beside the largest gradient, the largest parameter difference,
where it lies, the two gradients there, and how many elements differ by
more than 1e-5; after the last step, for each element more than 1e-5
apart (at most 5 a parameter), its gradient at every step on both sides.
With ``--resync`` each CPU step starts from the card's parameters and
Adam state before that step, so each step is compared alone.
It is the diagnosis behind ``chip_smoke.SSL_EPS_SET`` (PERF.md §6).
"""

import copy

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main():
    print(cs.nvidia_smi_line(), flush=True)
    cs.fp32_matmuls()
    root = tempfile.mkdtemp()
    resync = "--resync" in sys.argv
    for name in [a for a in sys.argv[1:] if a != "--resync"] or list(cs.SSL_FAMILY):
        data, engine_of = (cs.seq_split(), cs.seq_engine) if name in cs.SEQ_FAMILY else (cs.mf_split(), cs.ssl_engine)
        _, card = engine_of(name, 0, root, data)
        _, cpu = engine_of(name, 0, root, data, "cpu")
        cpu.model.load_state_dict(card.model.state_dict())
        batches = [x[:5] for x in card.epoch_fn.form(card.generator)]
        history = []
        with cs.DrawReplay() as replay:
            for step in range(5):
                before = ({k: v.detach().clone() for k, v in card.model.state_dict().items()},
                          copy.deepcopy(card.optimizer.state_dict()))
                replay.replaying = False
                loss = float(card.epoch_fn.run_batches(*(x[step:step + 1] for x in batches), generator=card.generator))
                if resync:
                    cpu.model.load_state_dict(before[0])
                    cpu.optimizer.load_state_dict(before[1])
                grads = {n: p.grad.detach().cpu().clone() for n, p in card.model.named_parameters()
                         if p.grad is not None}
                replay.replaying = True
                cpu_loss = float(cpu.epoch_fn.run_batches(*(x[step:step + 1] for x in batches),
                                                          generator=cpu.generator))
                out = [f"{name} step {step}: loss {loss:.6f} cpu {cpu_loss:.6f}"]
                on_cpu = dict(cpu.model.named_parameters())
                history.append({n: (grads[n], on_cpu[n].grad.detach().clone()) for n in grads})
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
        on_cpu = dict(cpu.model.named_parameters())
        for n, p in card.model.named_parameters():
            d = (p.detach().cpu() - on_cpu[n].detach()).abs().reshape(-1)
            for i in d.argsort(descending=True)[:5].tolist():
                if d[i] <= 1e-5:
                    break
                steps = ", ".join(f"{float(h[n][0].reshape(-1)[i]):.3g}/{float(h[n][1].reshape(-1)[i]):.3g}"
                                  for h in history if n in h)
                print(f"  {n}[{i}] |d| {float(d[i]):.3g}: grads card/cpu by step {steps}", flush=True)


if __name__ == "__main__":
    main()
