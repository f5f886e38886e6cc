"""Device and idle time charged to the program's spans, from synthetic
events and from a CPU profile of the program's own spans."""
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ttbench import spans
from ttbench.spans import OUTSIDE, Event, attribute
from ttbench.trace import REQUEST_RANGE, Interval, summarize


def _req(t0, t1):
    return Event(REQUEST_RANGE, t0, t1, id=1)


def test_a_device_op_is_charged_to_the_span_of_its_launch():
    host = [_req(0, 40), Event("tt.a", 0, 10, id=2),
            Event("tt.b", 20, 30, id=3),
            Event("cudaLaunchKernel", 4, 5, id=70)]
    # launched in tt.a, run while tt.b is open
    device = [Event("k", 22, 28, id=70)]
    s = attribute(host, device)
    assert s.rows["tt.a"].device_s == pytest.approx(6e-6)
    assert s.rows["tt.a"].ops == 1
    assert s.rows["tt.b"].device_s == 0 and s.rows["tt.b"].ops == 0
    assert s.unlinked == 0


def test_the_runtime_call_is_found_by_id_among_the_host_operations():
    # the host's operations number their ids apart from the runtime calls
    host = [_req(0, 40), Event("tt.a", 0, 10, id=11),
            Event("tt.b", 20, 30, id=2), Event("aten::mul", 21, 23, id=11),
            Event("cudaLaunchKernel", 22, 23, id=11)]
    device = [Event("k", 2, 8, id=11)]
    s = attribute(host, device)
    assert s.rows["tt.b"].device_s == pytest.approx(6e-6)
    assert s.rows["tt.a"].device_s == 0 and s.unlinked == 0


def test_a_gap_that_straddles_two_spans_is_split_at_the_boundary():
    host = [_req(0, 20), Event("tt.a", 0, 10, id=2),
            Event("tt.b", 10, 20, id=3)]
    device = [Event("k", 0, 5), Event("k", 15, 20)]
    s = attribute(host, device)
    assert s.rows["tt.a"].idle_s == pytest.approx(5e-6)
    assert s.rows["tt.b"].idle_s == pytest.approx(5e-6)
    assert s.unlinked == 2  # charged where they start on the host's clock


def test_the_innermost_span_wins():
    host = [_req(0, 100), Event("tt.outer", 0, 100, id=2),
            Event("tt.inner", 10, 20, id=3),
            Event("cudaLaunchKernel", 15, 16, id=50)]
    device = [Event("k", 40, 60, id=50)]
    s = attribute(host, device)
    assert s.rows["tt.inner"].device_s == pytest.approx(20e-6)
    assert s.rows["tt.inner"].host_s == pytest.approx(10e-6)
    assert s.rows["tt.outer"].host_s == pytest.approx(100e-6)
    assert s.rows["tt.inner"].idle_s == pytest.approx(10e-6)
    assert s.rows["tt.outer"].idle_s == pytest.approx(70e-6)
    assert s.rows["tt.outer"].device_s == 0


def test_time_outside_every_span_goes_to_outside():
    host = [_req(0, 50), Event("tt.a", 10, 20, id=2),
            Event("cudaLaunchKernel", 30, 31, id=60),
            Event("aten::randn", 29, 33, id=5)]
    device = [Event("k", 35, 40, id=60)]
    s = attribute(host, device)
    assert s.rows[OUTSIDE].device_s == pytest.approx(5e-6)
    # idle: 0-10 and 20-35 and 40-50 outside, 10-20 in tt.a
    assert s.rows[OUTSIDE].idle_s == pytest.approx(35e-6)
    assert s.rows["tt.a"].idle_s == pytest.approx(10e-6)


def test_summarize_is_unchanged_and_the_split_adds_up_to_it():
    # the inputs of test_ttbench_trace's first test
    host = [Interval(REQUEST_RANGE, 0, 100), Interval(REQUEST_RANGE, 100, 200),
            Interval("aten::linalg_svd", 38, 72),
            Interval("cudaStreamSynchronize", 40, 70),
            Interval("aten::randn", 150, 200)]
    device = [Interval("k1", 0, 30), Interval("k2", 10, 40),
              Interval("memcpy", 70, 100), Interval("k1", 100, 150),
              Interval("k3", 190, 260)]
    t = summarize(device, host)
    assert math.isclose(t.busy_s, 130e-6) and math.isclose(t.idle_s, 70e-6)
    assert dict(t.idle_gaps) == {
        "aten::randn": pytest.approx(40e-6),
        "cudaStreamSynchronize": pytest.approx(30e-6)}
    ev = [Event(h.name, h.start_us, h.end_us) for h in host]
    ev.append(Event("tt.recover", 30, 80, id=9))
    s = attribute(ev, [Event(d.name, d.start_us, d.end_us) for d in device])
    assert s.n_requests == t.n_requests and s.window_s == t.window_s
    assert sum(r.idle_s for r in s.rows.values()) == pytest.approx(t.idle_s)
    assert s.device_s(list(s.rows)) == pytest.approx(t.busy_s)
    assert s.rows["tt.recover"].idle_s == pytest.approx(30e-6)


def test_metrics_read_the_layers_and_the_counters():
    host = [_req(0, 100), Event("tt.slab_stream_sketch", 0, 60, id=2),
            Event("tt.kernel.dual_project", 5, 10, id=3),
            Event("cudaLaunchKernel", 6, 7, id=40),
            Event("tt.to_tt", 60, 90, id=4), Event("tt.lstsq", 65, 80, id=5),
            Event("cudaLaunchKernel", 66, 67, id=41),
            Event("tt.psi_index_add", 90, 95, id=6)]
    device = [Event("dual_project_kernel", 10, 50, id=40),
              Event("svd", 70, 75, id=41)]
    s = attribute(host, device, {"launches.dual_project": 1,
                                 "bytes.dual_project": 2_000_000})
    m = spans.metrics(s)
    assert m["kernel_gb_per_s.dense"] == pytest.approx(2e6 / 40e-6 / 1e9)
    assert m["device_ms.recovery"] == pytest.approx(5e-3)
    # recovery idle: 60-70 and 75-90; dispatch: 0-10 and 50-60, 90-95
    assert m["idle_ms.recovery"] == pytest.approx(25e-3)
    assert m["idle_ms.dispatch"] == pytest.approx(25e-3)
    assert m["idle_ms.outside"] == pytest.approx(5e-3)
    assert m["fallback_device_ms.sparse"] == 0
    assert s.rows["tt.kernel.dual_project"].launches == 1
    assert "tt.kernel.dual_project" in s.table()


def test_a_trace_without_the_spans_reads_no_span_metric():
    s = attribute([_req(0, 10)], [Event("k", 2, 4)])
    assert spans.metrics(s) == {"idle_ms.outside": pytest.approx(8e-3)}


def test_no_request_range_is_an_error():
    with pytest.raises(ValueError):
        attribute([Event("tt.a", 0, 1)], [])


def test_a_cpu_profile_of_the_programs_spans():
    from tt_sketch_torch import profiling

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function(REQUEST_RANGE):
                with profiling.span("tt.stream_sketch"):
                    with profiling.span("tt.mode.0"):
                        torch.ones(64, 64) @ torch.ones(64, 64)
    host, device = spans.events(prof)
    assert device == []
    s = attribute(host, device)
    assert s.n_requests == 2
    # no card: the whole window is idle, all of it in the spans or between
    total = sum(r.idle_s for r in s.rows.values())
    assert total == pytest.approx(s.window_s)
    assert s.rows["tt.mode.0"].idle_s > 0
    assert set(s.names("dispatch")) == {"tt.stream_sketch", "tt.mode.0"}
