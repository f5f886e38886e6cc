"""Device and idle time of a few traced requests split by the program's
spans.

``tt_sketch_torch.profiling.span`` opens a ``record_function`` range named
``tt.*`` while a ``torch.profiler`` records.  The profiler keeps those host
ranges and the device's kernels, copies and memsets on one clock, and a
device operation carries the correlation ``id`` of the host's runtime call
that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync`` and the like).

From those links, over the window of the traced requests (the harness's
``ttbench.request`` ranges):

- a device operation is charged to the innermost ``tt.*`` span open at its
  launch (the runtime call's start; without one, its own start, counted as
  ``unlinked``), wherever it runs later;
- an idle gap (no card works) is cut at the spans' starts and ends, and
  each piece is charged to the innermost span open then, or to
  ``OUTSIDE``;
- a span's device time is the union of the intervals of its operations.

The spans are taken as properly nested, as one host thread opens them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ttbench.trace import REQUEST_RANGE, _union

PREFIX = "tt."
OUTSIDE = "outside"
#: name prefixes of the host's CUDA calls (cudaLaunchKernel, cuLaunchKernel)
RUNTIME = ("cuda", "cu")

#: the spans of each layer, by name or by name prefix (ending in ".")
LAYERS = {
    "dispatch": ("tt.stream_sketch", "tt.hmt_sketch", "tt.orthogonal_sketch",
                 "tt.slab_stream_sketch", "tt.mode.", "tt.slab",
                 "tt.psi_index_add", "tt.kernel."),
    "recovery": ("tt.to_tt", "tt.recover", "tt.lstsq"),
}


@dataclass
class Event:
    """One profiler event; ``id`` its correlation id."""
    name: str
    start_us: float
    end_us: float
    id: int = 0


@dataclass
class SpanRow:
    host_s: float = 0.0
    device_s: float = 0.0
    idle_s: float = 0.0
    ops: int = 0
    launches: int = 0
    bytes: int = 0


@dataclass
class SpanSummary:
    """Per span name, over the traced requests: ``host_s`` the spans' own
    durations on the host, ``device_s`` the union of the charged
    operations, ``idle_s`` the idle time charged, ``ops`` the device
    operations charged, ``launches``/``bytes`` the change of the program's
    counters of a ``tt.kernel.<wrapper>`` span's wrapper."""
    n_requests: int
    window_s: float
    rows: Dict[str, SpanRow] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    unlinked: int = 0
    _device: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)

    def names(self, layer: str) -> List[str]:
        """The span names of the summary that belong to ``layer``."""
        return [n for n in self.rows if in_layer(n, layer)]

    def device_s(self, names: Iterable[str]) -> float:
        """Device busy time (the union) of the operations charged to any of
        ``names``."""
        parts = [self._device[n] for n in names if n in self._device]
        if not parts:
            return 0.0
        return float(np.diff(_union(np.concatenate(parts)), axis=1).sum())

    def idle_s(self, names: Iterable[str]) -> float:
        return float(sum(self.rows[n].idle_s for n in names
                         if n in self.rows))

    def table(self) -> str:
        """The by-span table: host, device and idle ms a request, device
        operations, launches and bytes counted (a request)."""
        n = max(1, self.n_requests)
        lines = [f"{'span':36s} {'host ms':>9s} {'device ms':>10s} "
                 f"{'idle ms':>9s} {'ops':>7s} {'launches':>9s} "
                 f"{'bytes':>13s}"]
        order = sorted(self.rows, key=lambda k: -(self.rows[k].device_s
                                                  + self.rows[k].idle_s))
        for name in order:
            r = self.rows[name]
            lines.append(f"{name:36s} {r.host_s / n * 1e3:9.4f} "
                         f"{r.device_s / n * 1e3:10.4f} "
                         f"{r.idle_s / n * 1e3:9.4f} {r.ops / n:7.1f} "
                         f"{r.launches / n:9.1f} {r.bytes / n:13.0f}")
        return "\n".join(lines)


def in_layer(name: str, layer: str) -> bool:
    return any(name.startswith(p) if p.endswith(".") else name == p
               for p in LAYERS[layer])


def events(prof) -> Tuple[List[Event], List[Event]]:
    """The host and device events of a finished ``torch.profiler`` (the
    device's as ``trace.intervals`` takes them: no mirrored host range)."""
    host, device = [], []
    for e in prof.events():
        tr = e.time_range
        item = Event(e.name, float(tr.start), float(tr.end), int(e.id))
        if str(e.device_type).endswith("CPU"):
            host.append(item)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith(("ttbench.", PREFIX))):
            device.append(item)
    return host, device


def _owners(spans: Sequence[Event]) -> Tuple[np.ndarray, np.ndarray]:
    """The innermost span as a step function of time: ``bounds`` (sorted)
    and ``owner`` (an index into ``spans`` or -1) from each bound on."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i].start_us, -spans[i].end_us))
    bounds, owner, stack = [], [], []

    def pop_until(t):
        while stack and spans[stack[-1]].end_us <= t:
            end = spans[stack.pop()].end_us
            bounds.append(end)
            owner.append(stack[-1] if stack else -1)

    for i in order:
        pop_until(spans[i].start_us)
        stack.append(i)
        bounds.append(spans[i].start_us)
        owner.append(i)
    pop_until(np.inf)
    return np.asarray(bounds, dtype=np.float64), np.asarray(owner, dtype=int)


def _owner_at(bounds, owner, t: np.ndarray) -> np.ndarray:
    if len(bounds) == 0:
        return np.full(np.shape(t), -1)
    k = np.searchsorted(bounds, t, side="right") - 1
    return np.where(k >= 0, owner[np.maximum(k, 0)], -1)


def attribute(host: List[Event], device: List[Event],
              counters: Optional[Dict[str, int]] = None) -> SpanSummary:
    """The by-span summary of the window of the request ranges in
    ``host``; ``counters``: the program's counters' change over it."""
    requests = [h for h in host if h.name == REQUEST_RANGE]
    if not requests:
        raise ValueError("no request range in the trace")
    w0 = min(r.start_us for r in requests)
    w1 = max(r.end_us for r in requests)
    spans = [h for h in host if h.name.startswith(PREFIX)]
    bounds, owner = _owners(spans)
    names = [s.name for s in spans]

    def name_of(i):
        return names[i] if i >= 0 else OUTSIDE

    # the launch time of each device operation in the window
    runtime = {h.id: h.start_us for h in host
               if h.id > 0 and h.name.startswith(RUNTIME)}
    dev = [d for d in device if d.end_us > w0 and d.start_us < w1]
    launch, unlinked = [], 0
    for d in dev:
        t = runtime.get(d.id)
        if t is None:
            unlinked += 1
            t = d.start_us
        launch.append(t)
    at = _owner_at(bounds, owner, np.asarray(launch, dtype=np.float64))

    out = SpanSummary(n_requests=len(requests), window_s=(w1 - w0) / 1e6,
                      counters=dict(counters or {}), unlinked=unlinked)
    rows: Dict[str, SpanRow] = {}
    by_name: Dict[str, list] = {}
    for d, i in zip(dev, at):
        name = name_of(int(i))
        by_name.setdefault(name, []).append(
            [max(d.start_us, w0), min(d.end_us, w1)])
        rows.setdefault(name, SpanRow()).ops += 1
    for name, iv in by_name.items():
        arr = np.asarray(iv, dtype=np.float64) / 1e6
        out._device[name] = arr
        rows[name].device_s = float(np.diff(_union(arr), axis=1).sum())

    # idle gaps, cut at the spans' bounds
    spans_dev = np.array([[max(d.start_us, w0), min(d.end_us, w1)]
                          for d in dev], dtype=np.float64).reshape(-1, 2)
    busy = _union(spans_dev)
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    for g0, g1 in gaps:
        lo = np.searchsorted(bounds, g0, side="right")
        hi = np.searchsorted(bounds, g1, side="left")
        cuts = np.concatenate([[g0], bounds[lo:hi], [g1]])
        who = _owner_at(bounds, owner, cuts[:-1])
        for a, b, i in zip(cuts[:-1], cuts[1:], who):
            if b > a:
                rows.setdefault(name_of(int(i)), SpanRow()).idle_s += \
                    (b - a) / 1e6

    for name, row in rows.items():
        if name.startswith(PREFIX + "kernel."):
            wrapper = name[len(PREFIX + "kernel."):]
            row.launches = int(out.counters.get(f"launches.{wrapper}", 0))
            row.bytes = int(out.counters.get(f"bytes.{wrapper}", 0))
    for sp in spans:
        rows.setdefault(sp.name, SpanRow()).host_s += max(
            0.0, min(sp.end_us, w1) - max(sp.start_us, w0)) / 1e6
    out.rows = rows
    return out


def counter_change(before: Dict[str, int], after: Dict[str, int]):
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(before) | set(after)
            if after.get(k, 0) != before.get(k, 0)}


def metrics(s: SpanSummary) -> Dict[str, float]:
    """The per-layer readings of a summary, a request each; a reading whose
    spans the trace lacks is left out."""
    n = max(1, s.n_requests)
    out = {}
    dispatch, recovery = s.names("dispatch"), s.names("recovery")
    if dispatch:
        out["idle_ms.dispatch"] = s.idle_s(dispatch) / n * 1e3
    if recovery:
        out["idle_ms.recovery"] = s.idle_s(recovery) / n * 1e3
        out["device_ms.recovery"] = s.device_s(recovery) / n * 1e3
    if "tt.psi_index_add" in s.rows:
        out["fallback_device_ms.sparse"] = \
            s.device_s(["tt.psi_index_add"]) / n * 1e3
    kern = "tt.kernel.dual_project"
    dual_s = s.device_s([kern])
    if kern in s.rows and dual_s > 0 and s.rows[kern].bytes > 0:
        out["kernel_gb_per_s.dense"] = s.rows[kern].bytes / dual_s / 1e9
    out["idle_ms.outside"] = s.idle_s([OUTSIDE]) / n * 1e3
    return out
