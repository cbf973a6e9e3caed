"""Run one cell of the benchmark:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the repository root.  Prints one JSON line last on stdout; exits
non-zero with no result without as many CUDA cards as the cell asks for.  A
model-sharded cell (``launch.py``) starts one process a card.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# One client process with one host thread for CPU operators: the card does
# the work, and spare host threads only add to the host's noise.
os.environ.setdefault("OMP_NUM_THREADS", "1")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    from perfbench import launch

    if launch.is_sharded(args.workload):
        sys.exit(launch.main(args, T_PROCESS))
    from perfbench import bench

    sys.exit(bench.main(args, T_PROCESS))
