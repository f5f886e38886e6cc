"""Spans and counters of ``tt_sketch_torch.profiling`` on the CPU: the no-op
span without a profiler, the library's spans and their nesting under a CPU
``torch.profiler``, the ``index_add_`` span and counter of a Ψ beyond the
segment kernel's fit, and the counter registry."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tt_sketch_torch import config, profiling
from tt_sketch_torch.dist import sharded
from tt_sketch_torch.drm import SparseGaussianDRM, TensorTrainDRM
from tt_sketch_torch.engine.sketch import (
    hmt_sketch,
    orthogonal_sketch,
    stream_sketch,
)
from tt_sketch_torch.formats import SparseTensor, TensorTrain
from tt_sketch_torch.kernels.dense_engine import slab_stream_sketch
from tt_sketch_torch.kernels.segment_psi import segment_fits

NNZ = 2000


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _sparse(n1=9, seed=0):
    """A float32 COO tensor of shape (11, n1, 30, 25) without plans: every
    mode takes the segment reduction."""
    shape = (11, n1, 30, 25)
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, n, NNZ) for n in shape])
    return SparseTensor(shape, idx, rng.standard_normal(NNZ).astype(
        np.float32))


def _stta(t):
    return stream_sketch(t, 10, 20, seed=1, left_drm_type=SparseGaussianDRM,
                         right_drm_type=SparseGaussianDRM,
                         dtype=torch.float32).to_tt()


def _hmt(t):
    return hmt_sketch(t, 10, seed=3, drm_type=SparseGaussianDRM,
                      dtype=torch.float32)


def _otts(t):
    return orthogonal_sketch(t, 5, 10, seed=4,
                             left_drm_type=SparseGaussianDRM,
                             right_drm_type=SparseGaussianDRM,
                             dtype=torch.float32)


def _slabs(n_slabs=4):
    X = TensorTrain.random((8, 6, 7, 5), 2, seed=0).to_dense().float()
    ld = TensorTrainDRM(3, X.shape, transpose=False, seed=1,
                        dtype=torch.float32)
    rd = TensorTrainDRM(5, X.shape, transpose=True, seed=2,
                        dtype=torch.float32)
    s = X.shape[0] // n_slabs
    return slab_stream_sketch(lambda i: X[i * s:(i + 1) * s], n_slabs,
                              tuple(X.shape), ld.cores, rd.cores)


def _spans(run):
    """The ``tt.*`` events of ``run()`` under a CPU profiler, in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return [e for e in prof.events() if e.name.startswith("tt.")]


def _ancestors(e):
    """The names of the ``tt.*`` ranges that hold ``e``, innermost first."""
    out, p = [], e.cpu_parent
    while p is not None:
        if p.name.startswith("tt."):
            out.append(p.name)
        p = p.cpu_parent
    return out


def _root(e):
    while e.cpu_parent is not None and any(
            a.startswith("tt.") for a in _ancestors(e)):
        e = e.cpu_parent
    return e


def test_without_a_profiler_a_span_is_the_shared_no_op():
    assert profiling.span("tt.anything") is profiling.NO_SPAN
    with profiling.span("tt.anything") as inside:
        assert inside is None

    @profiling.spanned("tt.decorated")
    def add(a, b=1):
        """Adds."""
        return a + b

    assert add(2, b=3) == 5 and add.__name__ == "add"
    _stta(_sparse())
    # nothing was kept for a later profiler to find
    assert _spans(lambda: None) == []


def test_a_span_under_a_profiler_is_a_named_range():
    @profiling.spanned("tt.decorated")
    def twice(x):
        with profiling.span("tt.inner"):
            return x * 2

    events = _spans(lambda: twice(torch.ones(3)))
    assert [e.name for e in events] == ["tt.decorated", "tt.inner"]
    assert _ancestors(events[1]) == ["tt.decorated"]


def test_stream_sketch_and_to_tt_nest_under_one_root_each():
    events = _spans(lambda: _stta(_sparse()))
    roots = [e.name for e in events if not _ancestors(e)]
    assert roots == ["tt.stream_sketch", "tt.to_tt"]
    modes = [e for e in events if e.name.startswith("tt.mode.")]
    # Ψ of each of the four modes, then Ω of the first three
    assert [e.name for e in modes] == [f"tt.mode.{m}" for m in
                                       (0, 1, 2, 3, 0, 1, 2)]
    assert all(_ancestors(e) == ["tt.stream_sketch"] for e in modes)
    kernels = [e for e in events if e.name.startswith("tt.kernel.")]
    assert {e.name for e in kernels} == {
        "tt.kernel.lazy_gaussian", "tt.kernel.psi_segment",
        "tt.kernel.omega_fused"}
    assert all(_ancestors(e)[0].startswith("tt.mode.")
               and _ancestors(e)[-1] == "tt.stream_sketch" for e in kernels)
    recovery = [(e.name, _ancestors(e)) for e in events
                if e.name in ("tt.recover", "tt.lstsq")]
    # the three Ω share a shape: one stacked factorisation, one span
    assert recovery == [("tt.recover", ["tt.to_tt"]),
                        ("tt.lstsq", ["tt.recover", "tt.to_tt"])]


def test_hmt_sketch_spans_its_modes_and_chain_kernels():
    events = _spans(lambda: _hmt(_sparse()))
    assert [e.name for e in events if not _ancestors(e)] == ["tt.hmt_sketch"]
    assert [e.name for e in events if e.name.startswith("tt.mode.")] == [
        f"tt.mode.{m}" for m in range(4)]
    chain = [e for e in events if e.name == "tt.kernel.chain_step_t"]
    assert [_ancestors(e)[0] for e in chain] == [
        f"tt.mode.{m}" for m in (1, 2, 3)]
    assert not any(e.name in ("tt.to_tt", "tt.recover", "tt.lstsq")
                   for e in events)


def test_orthogonal_sketch_spans_omega_and_psi_per_mode():
    events = _spans(lambda: _otts(_sparse()))
    assert [e.name for e in events if not _ancestors(e)] == [
        "tt.orthogonal_sketch"]
    # Ω of the first three modes, then Ψ of all four
    assert [e.name for e in events if e.name.startswith("tt.mode.")] == [
        f"tt.mode.{m}" for m in (0, 1, 2, 0, 1, 2, 3)]


def test_slab_stream_sketch_spans_each_slab():
    events = _spans(lambda: _slabs(4))
    assert [e.name for e in events if not _ancestors(e)] == [
        "tt.slab_stream_sketch"]
    slabs = [e for e in events if e.name == "tt.slab"]
    assert len(slabs) == 4
    assert all(_ancestors(e) == ["tt.slab_stream_sketch"] for e in slabs)
    projections = [e for e in events if e.name == "tt.kernel.dual_project"]
    assert [_ancestors(e) for e in projections] == [
        ["tt.slab", "tt.slab_stream_sketch"]] * 4


@pytest.mark.parametrize("run", [_stta, _hmt, _otts, "slabs"])
def test_spans_lie_inside_their_root(run):
    events = _spans((lambda: _slabs()) if run == "slabs"
                    else (lambda: run(_sparse())))
    assert events
    for e in events:
        root = _root(e)
        assert root.name.startswith("tt.")
        assert root.time_range.start <= e.time_range.start
        assert e.time_range.end <= root.time_range.end


@pytest.mark.parametrize("n1, index_add", [(88, False), (2990, False),
                                            (2991, True)])
def test_index_add_span_appears_exactly_above_max_cells(n1, index_add):
    # mode 1's Ψ is (10, n1, 20): left rank 10 from mode 0, right rank 20,
    # so 2 x 4 micro-tiles of 32 bytes of float32 bins a row: 2990 rows fit
    # the segment kernel beside its smallest ring, 2991 do not (88 rows,
    # 17,600 values, were above the cap of 16,384 values it replaces);
    # every other mode's Ψ fits
    assert segment_fits(torch.empty((10, 0)), torch.empty((20, 0)), n1,
                        torch.float32) != index_add
    profiling.reset_counters()
    events = _spans(lambda: _stta(_sparse(n1)))
    assert profiling.counters().get("fallbacks.psi_index_add", 0) == int(
        index_add)
    fallback = [e for e in events if e.name == "tt.psi_index_add"]
    assert len(fallback) == int(index_add)
    segments = [_ancestors(e)[0] for e in events
                if e.name == "tt.kernel.psi_segment"]
    if index_add:
        assert _ancestors(fallback[0]) == ["tt.mode.1", "tt.stream_sketch"]
        assert segments == ["tt.mode.0", "tt.mode.2", "tt.mode.3"]
    else:
        assert segments == [f"tt.mode.{m}" for m in range(4)]


def test_counters_start_at_zero_and_add_up():
    profiling.reset_counters()
    assert profiling.counters() == {}
    profiling.count("launches.w")
    profiling.count("bytes.w", 40)
    snapshot = profiling.counters()
    profiling.count("bytes.w", 2)
    assert snapshot == {"launches.w": 1, "bytes.w": 40}
    x = torch.zeros((3, 5), dtype=torch.float32)
    i = torch.zeros(7, dtype=torch.int64)
    profiling.launched("w", x, None, i)
    profiling.launched("w", i)
    assert profiling.counters() == {
        "launches.w": 3, "bytes.w": 40 + 2 + 60 + 56 + 56}
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_a_cpu_sketch_counts_no_launch():
    profiling.reset_counters()
    _stta(_sparse())
    _slabs()
    assert profiling.counters() == {}


def test_all_reduce_spans_and_counts_its_buffer(monkeypatch):
    parts = [torch.ones((2, 3), dtype=torch.float32),
             torch.ones(4, dtype=torch.float32)]
    mesh = SimpleNamespace(group=None)
    profiling.reset_counters()
    # without a process group nothing is reduced and nothing counted
    events = _spans(lambda: sharded._all_reduce_sum(mesh, parts))
    assert [e.name for e in events] == ["tt.all_reduce"]
    assert profiling.counters() == {}
    monkeypatch.setattr(sharded.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(sharded.dist, "all_reduce",
                        lambda flat, op=None, group=None: flat.mul_(2))
    out = sharded._all_reduce_sum(mesh, parts)
    assert [tuple(o.shape) for o in out] == [(2, 3), (4,)]
    assert all(bool((o == 2).all()) for o in out)
    assert profiling.counters() == {"bytes.all_reduce": 10 * 4}
