"""Run one cell of the benchmark once, on the card.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the result
as one JSON object; the numbers compared with the plain reference are the
last lines of standard error. Without enough CUDA devices it exits 2 and
prints no result. See README.md.
"""

import time

T_NOW = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.runner import main, process_start  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], process_start(T_NOW)))
