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
- ``span(name)`` (``spanned(name)`` as a decorator): a named range on the
  profiler's host timeline, which the profiler keeps on the same clock as
  the device's kernels, so a kernel or an idle gap can be put down to the
  innermost span open at its launch.  With no profiler recording a span
  costs one read of a flag and records nothing.  The library's spans:

  - entry and dispatch: ``tt.stream_sketch``, ``tt.hmt_sketch``,
    ``tt.orthogonal_sketch``, ``tt.slab_stream_sketch``; ``tt.mode.<μ>``
    around each mode's Ψ and Ω work; ``tt.slab`` around each slab of
    ``slab_stream_sketch``; ``tt.psi_index_add`` around a Ψ beyond the
    segment kernel's fit (``index_add_`` of outer products);
  - kernels: ``tt.kernel.<wrapper>`` around each kernel wrapper;
  - recovery: ``tt.to_tt``, ``tt.recover`` (``assemble_sketched_tt``),
    ``tt.lstsq`` (one around all the solves of a recovery),
    ``tt.kernel.jacobi_svd`` (the batched SVD of its Ω),
    ``tt.lstsq_svd_fallback`` around a ``torch.linalg.svd`` on a card
    (matrices beyond the Jacobi kernel's fit);
  - distribution: ``tt.all_reduce``.

- ``count(name, n)``, ``counters()``, ``reset_counters()``: counters that
  are always on.  Each kernel wrapper counts ``launches.<wrapper>`` and
  ``bytes.<wrapper>`` (operands read plus outputs written, from their
  shapes and dtypes); a sharded sketch's reduction counts
  ``bytes.all_reduce``; a Ψ beyond the segment kernel's fit counts
  ``fallbacks.psi_index_add``; a least-squares SVD on a card beyond the
  Jacobi kernel's fit counts ``fallbacks.lstsq_svd``.
"""
from __future__ import annotations

import functools
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional, Set

import torch
from torch.autograd import profiler as _autograd_profiler

from tt_sketch_torch.config import resolve_device


class _NoSpan:
    """The span when no profiler records: it enters, leaves and records
    nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


def span(name: str):
    """A ``record_function(name)`` range while a ``torch.profiler`` records,
    else the shared no-op context ``NO_SPAN``.

    >>> with profiling.span("tt.mode.2"):
    ...     psi = ...
    """
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _autograd_profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``
    (with no profiler recording, the call costs one flag read more)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _autograd_profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


_COUNTERS: Dict[str, int] = defaultdict(int)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _COUNTERS[name] += n


def counters() -> Dict[str, int]:
    """A snapshot of every counter (a counter never added to is absent)."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    """Set every counter back to zero."""
    _COUNTERS.clear()


def launched(wrapper: str, *tensors: Optional[torch.Tensor]) -> None:
    """Count one kernel launch of ``wrapper`` and, as its bytes, those of
    ``tensors`` (the launch's operands and outputs; None is skipped)."""
    _COUNTERS["launches." + wrapper] += 1
    _COUNTERS["bytes." + wrapper] += sum([t.nbytes for t in tensors
                                          if t is not None])


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
