"""CLI for the experiment suite (counterpart of
``tt_sketch_tpu/experiments/__main__.py``).

    python -m tt_sketch_torch.experiments list
    python -m tt_sketch_torch.experiments hilbert --quick
    python -m tt_sketch_torch.experiments all --out results --quick
    python -m tt_sketch_torch.experiments tt_sum --platform cpu

Every experiment writes or extends ``<out>/<name>.csv`` (the JAX package's
CSVs resume here too) and can be interrupted and re-run.  The experiments
run on the CUDA card unless ``--platform cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tt_sketch_torch.experiments",
        description="Resumable STTA benchmark experiments.",
    )
    parser.add_argument(
        "experiment",
        help="experiment name, 'all', 'list', or 'plot' (render CSV figures)",
    )
    parser.add_argument(
        "plot_target", nargs="?", default=None,
        help="with 'plot': experiment name or 'all'",
    )
    parser.add_argument("--out", default="results", help="output directory")
    parser.add_argument(
        "--quick", action="store_true",
        help="seconds-scale smoke grids instead of the full paper sweeps",
    )
    parser.add_argument(
        "--platform", choices=["cpu", "default"], default="default",
        help="cpu: run on the CPU (default: the CUDA card)",
    )
    parser.add_argument(
        "--no-progress", action="store_true", help="disable tqdm bars"
    )
    args = parser.parse_args(argv)

    if args.platform == "cpu":
        from tt_sketch_torch.config import set_default_device

        set_default_device("cpu")

    from tt_sketch_torch.experiments.drivers import (
        DRIVERS,
        available_experiments,
    )

    if args.experiment == "list":
        for name in available_experiments():
            print(name)
        return 0

    if args.experiment == "plot":
        from pathlib import Path

        from tt_sketch_torch.experiments import plots

        targets = (
            available_experiments()
            if args.plot_target in (None, "all")
            else [args.plot_target]
        )
        rendered = 0
        for name in targets:
            try:
                png = plots.render(name, out=args.out)
            except FileNotFoundError as e:
                if args.plot_target not in (None, "all"):
                    parser.error(str(e))
                continue
            print(f"[plot] {png}")
            rendered += 1
        if rendered == 0:
            print(f"no CSVs found in {Path(args.out).resolve()}")
        return 0

    names = available_experiments() if args.experiment == "all" else [
        args.experiment
    ]
    unknown = [n for n in names if n not in DRIVERS]
    if unknown:
        parser.error(
            f"unknown experiment(s) {unknown}; choose from "
            f"{available_experiments()} or 'all'"
        )

    for name in names:
        start = time.perf_counter()
        exp = DRIVERS[name](
            out=args.out, quick=args.quick, progress=not args.no_progress
        )
        print(
            f"[{name}] {len(exp.data)} rows in {exp.filename} "
            f"({time.perf_counter() - start:.1f}s)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
