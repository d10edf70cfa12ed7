"""The port's benchmark, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see ``harness.py``).  It needs a CUDA card
and the port's package under ``src/``; without either it exits with a
code other than 0 and prints no result."""
import time

T0 = time.perf_counter()  # set-up counts from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``portbench``) and ``src`` (for the port), in
# place of this folder, whose module names would shadow others
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
