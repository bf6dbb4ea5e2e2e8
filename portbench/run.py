"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; see ``portbench/README.md``.
"""

import time

_T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # the checkout's root, not this folder, goes first on the path
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    from portbench.harness.cli import main

    sys.exit(main(sys.argv[1:], t0=_T0))
