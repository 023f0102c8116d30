"""Run one cell of the benchmark once and print its result line.

    python3 ccd_bench/run.py --workload clothball.sim --seed 7 --seconds 30 --trace 0

See :mod:`ccd_bench.harness`.  Set-up is timed from the first line here.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, where the program and this folder are, in place of
# this folder, whose module names are not for import at the top level
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from ccd_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
