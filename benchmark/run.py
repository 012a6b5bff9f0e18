"""Run one cell of the benchmark once (see benchmark/README.md).

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""

import os
import sys
import time

T_START = time.time()
# a library that would load JAX by itself (transformers) is kept from it
os.environ.setdefault("USE_FLAX", "0")

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(1, os.path.dirname(_HERE))

from harness import common, runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], t_start=min(
        T_START, common.process_start_time())))
