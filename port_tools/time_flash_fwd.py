#!/usr/bin/env python3
"""Time the flash-attention forward kernel of one checkout of the port.

    python3 port_tools/time_flash_fwd.py <checkout root> <label> [dropout]

Needs a GPU. Imports ``beta_recsys_tpu_torch`` from ``<checkout root>``
(building its kernels there, in ``build/torch_kernels/``) and prints one
line: ``<label>`` and, for each shape, the mean microseconds of
``flash_causal_attention`` (CUDA events over 50 calls after 5 warm-ups)
and the sum of the output, which two checkouts must share. With
``dropout``, also the times at rate 0.1 (a checkout that takes a rate).

To compare two commits on one card, unpack the parent with ``git archive``
into a directory ``.gitignore`` lists and run, in one call, parent,
change, change, parent, each in its own process.
"""

import sys

import torch

sys.path.insert(0, sys.argv[1])
from beta_recsys_tpu_torch.ops.kernels.flash_attention import flash_causal_attention  # noqa: E402


def cuda_ms(fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main():
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for shape, dtype in (((1886, 100, 32), torch.float32), ((8192, 200, 32), torch.float32),
                         ((1886, 100, 32), torch.bfloat16), ((256, 100, 32), torch.float32),
                         ((256, 200, 32), torch.float32)):
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        out = flash_causal_attention(q, k, v)[0]
        res[f"{'x'.join(map(str, shape))} {str(dtype)[6:]}"] = (
            round(cuda_ms(lambda: flash_causal_attention(q, k, v)) * 1e3, 2), float(out.float().sum()))
    if len(sys.argv) > 3:
        seed = torch.tensor([5], device="cuda")
        for t in (100, 200):
            q, k, v = (torch.randn(256, t, 32, generator=gen, device="cuda") for _ in range(3))
            res[f"256x{t}x32 rate 0.1"] = (round(cuda_ms(lambda: flash_causal_attention(q, k, v, 0.1, seed)) * 1e3, 2),)
    print(sys.argv[2], res, flush=True)


if __name__ == "__main__":
    main()
