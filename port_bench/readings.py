"""The readings a cell's limits are set from, on the card at the cell's own
size (the benchmark's runs never run this):

    python3 port_bench/readings.py --workload <name> --program <seeds...>
        [--control <seeds...>] [--fault <name> <seeds...>]... [--out <file>]

``--program``: the numbers ``correct`` compares for sound runs, one set-up
and check a seed (no measured window: the checked calls are set-up's).
``--control``: the reference in the program's place, computed in TF32 (the
precision below the configuration's float32 with TF32 off), against the
float32 reference. ``--fault``: the program with a fault planted
("half_batch", "unchanged" for training; "half_batch", "altered_answer"
for evaluation). One JSON line a reading, to standard output and to
``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.compare import moving_leaves  # noqa: E402
from harness.spec import load_cell  # noqa: E402


def reading(cell, seed, device, kind, fault=None):
    """{number: value} of one reading: kind "program", "control" or
    "fault"."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = cell.driver().Driver(cell, seed, torch.device(device), fault=fault)
    driver.setup()
    driver.release()
    reference = driver.reading()
    if kind == "control":
        output = driver.reading(tf32=True)
        if "metrics" in output:  # an evaluation: the control's answer is one pass
            output = {"passes": [output["metrics"]], "scores": output["scores"]}
    else:
        output = driver.program if "grad_norms" in reference else {"passes": driver.passes,
                                                                 "scores": driver.held_out_scores}
    numbers = driver.numbers(output, reference)
    if "grad_norms" in reference:  # training: the leaves the change leaves out
        numbers["left_out"] = sorted(set(reference["grad_norms"]) - set(moving_leaves(reference["grad_norms"])))
    return numbers


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program", type=int, nargs="*", default=[])
    parser.add_argument("--control", type=int, nargs="*", default=[])
    parser.add_argument("--fault", nargs="+", action="append", default=[])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    cell = load_cell(HERE.parent, args.workload)
    jobs = [("program", None, s) for s in args.program] + [("control", None, s) for s in args.control]
    jobs += [("fault", f[0], int(s)) for f in args.fault for s in f[1:]]
    out = open(args.out, "a") if args.out else None
    for kind, fault, seed in jobs:
        t0 = time.perf_counter()
        numbers = reading(cell, seed, args.device, kind, fault)
        line = json.dumps({"workload": args.workload, "kind": kind, "fault": fault, "seed": seed,
                           "numbers": numbers, "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
