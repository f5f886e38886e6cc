"""One run of one cell: set-up, a closed-loop window with one client, an
optional traced part, the check against the plain reference, one result
line.

Everything specific to a configuration, a traffic mix or a metric is data
or a file of its own, found by its name in ``BENCHMARK.json``:
``configs/<config>.json`` (sizes, data, value type, ``kind``),
``traffic/<cell>.json`` (the method a request calls, its ranks and DRMs,
the requests checked and the limits), ``metrics/<metric>.py`` (a reader
per metric).  A configuration's ``kind`` is ``inputs/<kind>.py``, which
makes or reads its inputs.  The method named by a traffic file is
``methods/<method>.py``: its ``request`` calls the program, its
``reference`` the plain reference, its ``work`` counts a request's bytes
and flops from shapes and ranks alone (``work/counts.py``).  A cell runs on
as many cards as its entry's ``chips``.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import torch

from ttbench import check, inputs, trace
from ttbench.reference.hashrows import splitmix_int

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tt_sketch_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the port may not use."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file whose name may hold dots and dashes."""
    name = "ttbench_file_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def method_module(name: str):
    return importlib.import_module(f"ttbench.methods.{name}")


def request_seed(seed: int, k: int) -> int:
    """The seed of request ``k`` (warm-up requests: negative ``k``)."""
    return splitmix_int((int(seed) * 0x100000001B3 + k) % (1 << 64)) \
        % (1 << 31)


class Clock:
    """The host's clock at a request's end, after the host has waited for
    the cards (a no-op without one).  With ``stages`` it also waits at the
    end of a request's sketch and stamps it, so that the recovery after it
    reads alone; without, ``stage`` stamps nothing and waits for nothing."""

    def __init__(self, devices, stages: bool = False) -> None:
        self.cuda = [d for d in devices if d.type == "cuda"]
        self.stages = stages

    def done(self) -> float:
        for d in self.cuda:
            torch.cuda.synchronize(d)
        return time.perf_counter()

    def stage(self) -> Optional[float]:
        return self.done() if self.stages else None


class Cell:
    """A cell's entry, configuration and traffic, with its files found by
    name."""

    def __init__(self, manifest: dict, name: str,
                 config: Optional[dict] = None,
                 traffic: Optional[dict] = None) -> None:
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.config = config or load_json(
            HERE / "configs" / f"{self.entry['config']}.json")
        self.traffic = traffic or load_json(HERE / "traffic" / f"{name}.json")
        self.method = method_module(self.traffic["method"])
        self.metrics = {
            "end_to_end": [m for m in manifest["end_to_end"]
                           if self.reports(m)],
            "per_layer": [m for m in manifest["per_layer"]
                          if self.reports(m)]}
        self.metric_dir = HERE / "metrics"

    def devices(self, device: str = "cuda"):
        """The first ``chips`` cards of the entry, or one ``device``."""
        if device != "cuda":
            return [torch.device(device)]
        return [torch.device("cuda", i)
                for i in range(int(self.entry["chips"]))]

    def reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def run_requests(cell, data, seed: int, first: int, clock, until=None,
                 count=None, wrap=None, keep=None):
    """Requests ``first, first + 1, ...`` back to back (one client) until
    ``until`` (host seconds) or ``count`` requests; per request, on the
    host's clock: its time to the TT complete on the cards, its recovery's
    time where the clock stamps stages, its sketch call's time."""
    records, k = [], first
    while True:
        if count is not None and k - first >= count:
            break
        if until is not None and k > first and time.perf_counter() >= until:
            break
        s = request_seed(seed, k)
        with wrap() if wrap else contextlib.nullcontext():
            t0 = time.perf_counter()
            try:
                out = cell.method.request(data, cell.config, cell.traffic, s,
                                          clock)
                failed = False
            except RuntimeError as exc:  # a failed request: counted
                if not any(r["failed"] for r in records):
                    print(f"# request {k} (seed {s}) failed: {exc!r}",
                          file=sys.stderr)
                out, failed = None, True
            t2 = clock.done()
        rec = {"k": k, "seed": s, "failed": failed,
               "ms": (t2 - t0) * 1e3, "recover_ms": None, "enqueue_s": None}
        if out is not None:
            rec["enqueue_s"] = out["enqueue_s"]
            if out["mid"] is not None:
                rec["recover_ms"] = (t2 - out["mid"]) * 1e3
            if keep is not None:
                keep.offer((s, out))
        records.append(rec)
        k += 1
    return records


def traced_requests(cell, data, seed: int, first: int, clock, count: int):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        records = run_requests(cell, data, seed, first, clock, count=count,
                               wrap=lambda: record_function(
                                   trace.REQUEST_RANGE))
    device, host = trace.intervals(prof)
    return records, trace.summarize(device, host, max(1, len(clock.cuda)))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device="cuda", t_start: Optional[float] = None,
        repo: Path = HERE.parent) -> dict:
    """One run; returns the result line's object.  On the card the cell
    takes the first ``chips`` of its entry's devices.

    A traced run reports per-layer metrics only; its window stamps each
    request's stages (``Clock``) for ``recover_ms``, and its traced part,
    which does not, gives the trace's metrics."""
    t_start = time.perf_counter() if t_start is None else t_start
    devices = cell.devices(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = Clock(devices)
    chk = cell.traffic["check"]

    data = inputs.make(cell.config, seed, devices, repo)
    warm = run_requests(cell, data, seed, -int(cell.traffic["warmup"]),
                        clock, count=int(cell.traffic["warmup"]))
    if any(r["failed"] for r in warm):
        raise RuntimeError("a warm-up request failed")
    setup_s = clock.done() - t_start

    keep = check.Reservoir(int(chk["requests"]), seed)
    t0 = time.perf_counter()
    records = run_requests(cell, data, seed, 0, Clock(devices, traced),
                           until=t0 + seconds, keep=keep)
    window_s = time.perf_counter() - t0
    summary = None
    t1 = time.perf_counter()
    if traced:
        _, summary = traced_requests(cell, data, seed, len(records), clock,
                                     int(cell.traffic["trace_requests"]))
    t2 = time.perf_counter()
    peak = max((torch.cuda.max_memory_allocated(d) for d in clock.cuda),
               default=0)

    # the check: the program's own state goes first, the reference runs
    # in blocks on what the benchmark made or read
    data["program"].clear()
    if clock.cuda:
        torch.cuda.empty_cache()
    points = check.sample_points(cell.config, data["raw"],
                                 int(chk["points"]), seed, devices[0])
    readings = []
    for s, out in keep.items:
        ref = cell.method.reference(data, cell.config, cell.traffic, s,
                                    "float64")
        readings.append(check.compare(out, ref, points))
        del ref
    numbers = check.worst(readings)
    print(f"# set-up {setup_s:.3f} s, window {window_s:.3f} s "
          f"({len(records)} requests), traced part {t2 - t1:.3f} s, check "
          f"{time.perf_counter() - t2:.3f} s ({len(readings)} requests)",
          file=sys.stderr)
    limits = {k: float(v) for k, v in chk["limits"].items()}
    failed = sum(r["failed"] for r in records)
    correct = (check.verdict(numbers, limits) and failed == 0
               and len(records) > 0)

    work = cell.method.work(cell.config, cell.traffic)
    ctx = SimpleNamespace(cell=cell, records=records, window_s=window_s,
                          setup_s=setup_s, work=work, trace=summary)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        value = load_module(cell.metric_dir / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if clock.cuda else devices[0].type,
           "kind": (torch.cuda.get_device_name(devices[0])
                    if clock.cuda else "cpu"),
           "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        if clock.cuda:
            dev["power"] = power_limit()
        result["breakdown"] = {
            "device_ops": [list(x) for x in summary.device_ops],
            "idle_gaps": [list(x) for x in summary.idle_gaps]}
    # a number that is missing or not finite is printed as null (and has
    # already failed its limit)
    result["check"] = {
        k: {"value": (numbers[k] if math.isfinite(numbers.get(k, math.inf))
                      else None), "limit": v}
        for k, v in limits.items()}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    repo = HERE.parent
    manifest = load_json(repo / "BENCHMARK.json")
    entry = {w["name"]: w for w in manifest["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = run(Cell(manifest, args.workload), args.seed, args.seconds,
                 bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0
