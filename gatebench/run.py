"""Run one cell of the GATE benchmark once and print its result's line.

    python gatebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Exits non-zero, printing no result, without
the CUDA cards the cell asks for.
"""
import time

T_START = time.perf_counter()   # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from gatebench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
