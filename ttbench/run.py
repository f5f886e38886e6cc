"""Run one cell of the benchmark of tt_sketch_torch once.

    python3 ttbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; prints one JSON line last on standard output.
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from ttbench.harness import main

    sys.exit(main(t_start=T_START))
