"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m perfbench.run ...``) from the root of a checkout.  Set-up
starts when this file starts; see ``harness.py``."""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if not __package__:              # run as a script: the checkout's root, not perfbench/
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T0))
