"""The readings a cell's limits are set from: for each seed, one run of
the cell (`harness.main.execute`, a short window at the cell's own
load) and the numbers it compares; with `--control`, beside them the
lower-precision control's (the reference computed in fp8, in the
program's place, on the same prompts and served tokens).  All seeds run
in one process, one JSON line each.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 10 [--control]

The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.harness import main  # noqa: E402


def cli(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    main.prepare_environment(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, _ = main.execute(args.workload, seed, args.seconds, False,
                                 control=args.control)
        readings = result.get("readings") or {
            k: c["value"] for k, c in result["checks"].items()}
        print(json.dumps({"seed": seed, "readings": readings,
                          "correct": result["correct"],
                          "metrics": result["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
