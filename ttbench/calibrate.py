"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 ttbench/calibrate.py --workload <cell> --seeds 12 --controls 3

In one process and at the cell's own sizes: for each of ``--seeds`` seeds,
as many requests as a run checks, through the program's timed path, each
compared with the float64 reference (the lower readings); then, for
``--controls`` seeds, the reference computed in the precision just below
the configuration's (the traffic file's ``control``) in the program's
place, compared the same way (the upper readings).  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ttbench import check, harness, inputs  # noqa: E402


def readings(cell, seeds, controls, device="cuda", repo=harness.HERE.parent,
             first_seed=1000):
    """Yields one dict a seed: the program's and then the control's worst
    numbers over a run's checked requests."""
    devices = cell.devices(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = harness.Clock(devices)
    chk = cell.traffic["check"]
    k_req = int(chk["requests"])
    method = cell.method
    data = inputs.make(cell.config, first_seed, devices, repo)
    harness.run_requests(cell, data, first_seed, -1, clock, count=1)
    jobs = [("program", first_seed + i) for i in range(seeds)]
    jobs += [("control", first_seed + 500 + i) for i in range(controls)]
    for side, seed in jobs:
        points = check.sample_points(cell.config, data["raw"],
                                     int(chk["points"]), seed, devices[0])
        nums = []
        for k in range(k_req):
            s = harness.request_seed(seed, k)
            ref = method.reference(data, cell.config, cell.traffic, s,
                                   "float64")
            if side == "program":
                out = method.request(data, cell.config, cell.traffic, s,
                                     clock)
            else:
                out = method.reference(data, cell.config, cell.traffic, s,
                                       chk["control"])
            nums.append(check.compare(out, ref, points))
            del ref, out
        yield {"side": side, "seed": seed, **check.worst(nums)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=1000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    manifest = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    cell = harness.Cell(manifest, args.workload)
    for row in readings(cell, args.seeds, args.controls,
                        first_seed=args.first_seed):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
