"""Run one cell of the port's benchmark once; see :mod:`portbench.harness.runner`.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
