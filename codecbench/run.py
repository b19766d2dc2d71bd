"""codecbench: one run of one cell of BENCHMARK.json.

    python3 codecbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the program
(``aivc_tpu_torch``) on a machine with the cell's CUDA devices.  Prints
the correctness checks on standard error and the result as one JSON
line on standard output."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.append(str(ROOT))

from harness.bench import run  # noqa: E402

if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(run(sys.argv[1:], ROOT, T_START))
