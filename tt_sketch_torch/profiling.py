"""Profiling and per-stage timing.

Counterpart of ``tt_sketch_tpu/profiling.py``:

- ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU
  activities, and CUDA ones when a card is present) that writes a
  Chrome/Perfetto trace file (``trace_<pid>_<ns>.json``) of everything run
  inside it into ``logdir``.  The JAX package's ``create_perfetto_link``
  has no counterpart and raises.
- ``StageTimer``: named wall-clock stages with device-completion
  semantics: each ``stop`` waits for the devices of the tensors it is
  handed, so a stage time means "device finished", not "launch queued".
- ``memory_stats``: the CUDA caching allocator's statistics.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional, Set

import torch

from tt_sketch_torch.config import resolve_device


@contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Capture a host and device trace into ``logdir`` (open the file in
    Perfetto or ``chrome://tracing``).

    >>> with profiling.trace("tt-trace"):
    ...     stream_sketch(tensor, 10, 20).to_tt()
    """
    if create_perfetto_link:
        raise ValueError(
            "create_perfetto_link has no counterpart in torch.profiler; open "
            "the trace file written into logdir in Perfetto instead"
        )
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(
            str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _devices(value: Any, found: Set[torch.device], seen: Set[int]) -> None:
    """Collect the devices of the tensors in ``value``: tuples, lists and
    dicts are walked, and so are the attributes of this package's objects
    (a TT's cores, a sketch's Ψ/Ω, a DRM's cores)."""
    if isinstance(value, torch.Tensor):
        found.add(value.device)
        return
    if id(value) in seen:
        return
    seen.add(id(value))
    if isinstance(value, (tuple, list)):
        items = value
    elif isinstance(value, dict):
        items = value.values()
    elif type(value).__module__.startswith("tt_sketch_torch"):
        items = vars(value).values() if hasattr(value, "__dict__") else ()
    else:
        return
    for item in items:
        _devices(item, found, seen)


def block_until_ready(value: Any) -> Any:
    """Wait until the devices of every tensor in ``value`` are done (the
    counterpart of ``jax.block_until_ready``); returns ``value``."""
    found: Set[torch.device] = set()
    _devices(value, found, set())
    for dev in found:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return value


class StageTimer:
    """Accumulate named stage wall-times with device completion.

    >>> t = StageTimer()
    >>> with t.stage("sketch", result := sketch_fn()):
    ...     pass                       # or use t.stop("sketch", result)
    Simpler imperative form:
    >>> t.start("sketch"); out = sketch_fn(); t.stop("sketch", out)
    """

    def __init__(self) -> None:
        self.times: Dict[str, List[float]] = {}
        self._open: Dict[str, float] = {}

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str, value: Any = None) -> float:
        if value is not None:
            block_until_ready(value)
        elapsed = time.perf_counter() - self._open.pop(name)
        self.times.setdefault(name, []).append(elapsed)
        return elapsed

    @contextmanager
    def stage(self, name: str, value: Any = None):
        self.start(name)
        try:
            yield self
        finally:
            self.stop(name, value)

    def total(self, name: str) -> float:
        return float(sum(self.times.get(name, [])))

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.times.items():
            out[name] = {
                "count": float(len(vals)),
                "total_s": float(sum(vals)),
                "mean_s": float(sum(vals) / len(vals)),
                "max_s": float(max(vals)),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(
            self.summary().items(), key=lambda kv: -kv[1]["total_s"]
        ):
            lines.append(
                f"{name:24s} n={int(s['count']):4d} total={s['total_s']:8.3f}s "
                f"mean={s['mean_s']*1e3:8.2f}ms max={s['max_s']*1e3:8.2f}ms"
            )
        return "\n".join(lines)


def memory_stats(device: Optional[Any] = None) -> Dict[str, int]:
    """The CUDA caching allocator's statistics of ``device`` (default: the
    package default) as ints (``allocated_bytes.all.peak`` is the peak);
    ``{}`` on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    return {k: int(v) for k, v in torch.cuda.memory_stats(dev).items()}
