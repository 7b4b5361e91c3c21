"""One run of one benchmark cell of orz_tpu_torch on one machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; prints one JSON line last (see
``harness.py``).  Exits 2 without a CUDA card.
"""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
