"""Run one cell of the benchmark once; see egobench/harness/main.py.

    python3 egobench/run.py --workload solve-seq32-clean --seed 7 \
        --seconds 50 --trace 0
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from egobench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
