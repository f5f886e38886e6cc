"""One traced run of a benchmark cell, with its traced part's device and
idle time split by the program's spans.

    python3 tools/span_breakdown.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a machine with a card.  It runs
``ttbench.harness.run`` as ``ttbench/run.py --trace 1`` does, with the same
profile of the traced part, and also keeps that profile's ``tt.*`` spans
(``ttbench/spans.py``) and the change of the program's counters over it.
Standard error gets the by-span table (device ms, idle ms, device
operations, launches and bytes, a request) and the readings of the span
metrics beside the harness's own; the last line of standard output is one
JSON object: the harness's result, ``spans`` (the readings and the table's
rows) and ``agree`` (each reading set beside the harness's metric it
should agree with):

- ``device_ms.recovery`` + ``idle_ms.recovery`` against ``recover_ms``;
- the host duration of ``tt.stream_sketch`` and of ``tt.to_tt`` against
  ``enqueue_ms.sparse`` and ``recover_ms``;
- ``idle_ms.dispatch`` + ``idle_ms.recovery`` + ``idle_ms.outside``
  against the traced part's idle time a request;
- ``fallback_device_ms.sparse`` against the device's busy time a request;
- ``kernel_gb_per_s.dense`` against the wrapper's bytes over the device time
  of ``dual_project_kernel`` in the breakdown.
"""
import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def breakdown(cell, seed: int, seconds: float, device: str = "cuda",
              repo: Path = ROOT, t_start=None) -> dict:
    """``harness.run(cell, ...)`` traced, with the traced part's spans:
    the result object with ``spans`` added."""
    from ttbench import harness, spans, trace
    from tt_sketch_torch import profiling

    kept = []

    def traced_requests(cell, data, seed, first, clock, count):
        from torch.profiler import ProfilerActivity, profile, record_function

        before = profiling.counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            records = harness.run_requests(
                cell, data, seed, first, clock, count=count,
                wrap=lambda: record_function(trace.REQUEST_RANGE))
        change = spans.counter_change(before, profiling.counters())
        device, host = trace.intervals(prof)
        kept.append(spans.attribute(*spans.events(prof), change))
        return records, trace.summarize(device, host,
                                        max(1, len(clock.cuda)))

    saved = harness.traced_requests
    harness.traced_requests = traced_requests
    try:
        result = harness.run(cell, seed, seconds, True, device, t_start,
                             repo)
    finally:
        harness.traced_requests = saved
    s = kept[0]
    readings = spans.metrics(s)
    n = max(1, s.n_requests)
    layer = {k: v["value"] for k, v in result["metrics"].items()}
    dev = result["device"]
    agree = {}
    if "device_ms.recovery" in readings and "recover_ms" in layer:
        agree["recovery_ms"] = [
            readings["device_ms.recovery"] + readings["idle_ms.recovery"],
            layer["recover_ms"]]
    idle = sum(readings.get(k, 0.0) for k in (
        "idle_ms.dispatch", "idle_ms.recovery", "idle_ms.outside"))
    agree["idle_ms"] = [idle, (dev["window_s"] - dev["busy_s"]) / n * 1e3]
    if "tt.stream_sketch" in s.rows and "enqueue_ms.sparse" in layer:
        agree["enqueue_ms"] = [s.rows["tt.stream_sketch"].host_s / n * 1e3,
                               layer["enqueue_ms.sparse"]]
    if "tt.to_tt" in s.rows and "recover_ms" in layer:
        agree["to_tt_host_ms"] = [s.rows["tt.to_tt"].host_s / n * 1e3,
                                  layer["recover_ms"]]
    if "fallback_device_ms.sparse" in readings:
        agree["fallback_of_busy_ms"] = [readings["fallback_device_ms.sparse"],
                                        dev["busy_s"] / n * 1e3]
    if "kernel_gb_per_s.dense" in readings:
        kernel_s = sum(t for name, t in result["breakdown"]["device_ops"]
                       if "dual_project_kernel" in name)
        row = s.rows["tt.kernel.dual_project"]
        agree["kernel_gb_per_s"] = [readings["kernel_gb_per_s.dense"],
                                    row.bytes / kernel_s / 1e9
                                    if kernel_s else None]
    print(s.table(), file=sys.stderr)
    print(f"# {s.n_requests} traced requests, {s.unlinked} device "
          f"operations without a link", file=sys.stderr)
    for k, v in sorted(readings.items()):
        print(f"span {k} {v!r}", file=sys.stderr)
    for k, (a, b) in agree.items():
        print(f"agree {k} {a!r} against {b!r}", file=sys.stderr)
    result["spans"] = {
        "readings": readings, "agree": agree, "unlinked": s.unlinked,
        "n_requests": s.n_requests, "counters": s.counters,
        "rows": {k: vars(r) for k, r in s.rows.items()}}
    return result


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from ttbench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    result = breakdown(harness.Cell(manifest, args.workload), args.seed,
                       args.seconds, t_start=T_START)
    sys.stdout.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
