"""Device busy and idle time, launches and the breakdown, from a profiler
trace of a few requests.

The arithmetic follows the smoke script's profile window (device time by
kernel, busy over the window), with busy time taken as the union of the
device intervals (kernels, copies, memsets), so that kernels that overlap
on several streams count once.  The window runs from the first traced
request's start to the last one's end (the harness marks each request with
a ``ttbench.request`` range).  Busy time is each card's union, averaged
over the cards the cell uses.  Each idle gap, when no card works, is put
down to the host operation that overlapped it most (the innermost on a
tie).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

REQUEST_RANGE = "ttbench.request"
TOP = 10


@dataclass
class Interval:
    name: str
    start_us: float
    end_us: float
    device: int = 0


@dataclass
class TraceSummary:
    n_requests: int
    window_s: float
    busy_s: float
    device_events: int
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_s(self) -> float:
        return self.window_s - self.busy_s


def _union(spans: np.ndarray) -> np.ndarray:
    """Merged, sorted (k, 2) intervals of (n, 2) ``spans``."""
    if len(spans) == 0:
        return spans.reshape(0, 2)
    spans = spans[np.argsort(spans[:, 0])]
    out = [list(spans[0])]
    for s, e in spans[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def summarize(device: List[Interval], host: List[Interval],
              n_devices: int = 1) -> TraceSummary:
    """``device``: the cards' kernels, copies and memsets; ``host``: the
    host's operations, the harness's request ranges among them;
    ``n_devices``: the cards the cell uses."""
    requests = [h for h in host if h.name == REQUEST_RANGE]
    if not requests:
        raise ValueError("no request range in the trace")
    w0 = min(r.start_us for r in requests)
    w1 = max(r.end_us for r in requests)
    dev = [d for d in device if d.end_us > w0 and d.start_us < w1]
    spans = np.array([[max(d.start_us, w0), min(d.end_us, w1)] for d in dev],
                     dtype=np.float64).reshape(-1, 2)
    on = np.array([d.device for d in dev])
    busy_us = sum(float(np.diff(_union(spans[on == i]), axis=1).sum())
                  for i in set(on.tolist())) / n_devices
    busy = _union(spans)

    by_op = {}
    for d, (s, e) in zip(dev, spans):
        by_op[d.name] = by_op.get(d.name, 0.0) + (e - s)
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]

    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    others = [h for h in host if not h.name.startswith("ttbench.")]
    hs = np.array([h.start_us for h in others], dtype=np.float64)
    he = np.array([h.end_us for h in others], dtype=np.float64)
    by_host = {}
    for g0, g1 in gaps:
        name = "(no host operation)"
        if len(others):
            overlap = np.minimum(he, g1) - np.maximum(hs, g0)
            best = overlap.max()
            if best > 0:
                ties = np.nonzero(overlap >= best)[0]
                name = others[ties[np.argmin((he - hs)[ties])]].name
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0)
    idle_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        n_requests=len(requests), window_s=(w1 - w0) / 1e6,
        busy_s=busy_us / 1e6, device_events=len(dev),
        device_ops=[(n, us / 1e6) for n, us in device_ops],
        idle_gaps=[(n, us / 1e6) for n, us in idle_gaps])


def intervals(prof) -> Tuple[List[Interval], List[Interval]]:
    """The device and host intervals of a finished ``torch.profiler``."""
    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        item = Interval(e.name, float(tr.start), float(tr.end),
                        max(0, int(getattr(e, "device_index", 0))))
        if str(e.device_type).endswith("CPU"):
            host.append(item)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith("ttbench.")):
            # a host range mirrored on the device's timeline is no work
            device.append(item)
    return device, host
