"""Run one cell of the port's benchmark once, on the CUDA card of this
machine, and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), when the port is missing from the checkout, or
when the process has loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    main.prepare_environment(ROOT)
    sys.exit(main.cli(sys.argv[1:], T_START))
