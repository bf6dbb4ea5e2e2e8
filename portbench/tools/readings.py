"""Read the numbers that decide ``correct`` over many seeds in one process:
the program's (``--mode program``), the control's (``--mode control``: the
fp8 reference in the program's place) or a planted fault's (``--mode
fault:<name>``), each at the cell's own size, one JSON line per seed.
This is how the limits in ``limits/`` were set; the benchmark's own runs
never take this path.

    python3 portbench/tools/readings.py --workload <name> --mode control \\
        --seeds 11,12,13 [--seconds 4]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent.parent)

from portbench.harness.cli import run_cell  # noqa: E402
from portbench.harness.spec import Spec  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args()
    spec = Spec()
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        out, _cell, _rc, _ = run_cell(spec, args.workload, int(s), args.seconds, False, t0,
                                      mode=args.mode)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": int(s),
                          "numbers": out.numbers, "attempted": out.attempted,
                          "failed": out.failed, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
