"""The profiling module of ``tt_sketch_torch`` (``profiling.py``) on the
CPU, with ``tests/test_profiling.py``'s checks of the JAX package's: stage
timers on torch tensors and on the port's tensor objects, a trace file,
memory statistics."""
import json

import jax.numpy as jnp
import pytest
import torch

from tt_sketch_torch import StageTimer, config, profiling, stream_sketch
from tt_sketch_torch.formats import TensorTrain
from tt_sketch_tpu import profiling as jprofiling


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def test_stage_timer():
    t = StageTimer()
    t.start("a")
    x = torch.ones((100, 100)) @ torch.ones((100, 100))
    dt = t.stop("a", x)
    assert dt > 0
    with t.stage("b"):
        _ = torch.zeros(10)
    s = t.summary()
    assert set(s) == {"a", "b"}
    assert s["a"]["count"] == 1
    assert "a" in t.report() and "total=" in t.report()
    assert t.total("a") == pytest.approx(dt)
    assert t.total("missing") == 0.0


def test_stage_timer_report_matches_jax():
    """The same stage times give the JAX package's summary and report."""
    ours, ref = StageTimer(), jprofiling.StageTimer()
    for timer in (ours, ref):
        timer.times = {"sketch": [0.5, 0.25], "round": [0.125]}
    assert ours.summary() == ref.summary()
    assert ours.report() == ref.report()
    ref.start("j")
    ref.stop("j", jnp.ones(4))


def test_stage_timer_on_tensor_objects():
    """``stop`` walks tuples, lists, dicts and the port's tensor objects
    (a TT's cores, a sketch's Ψ/Ω and DRMs) for the devices to wait on."""
    tt = TensorTrain.random((5, 6, 7), 2, seed=0)
    sk = stream_sketch(tt, 2, 4, seed=1)
    found = set()
    profiling._devices({"tt": tt, "parts": [sk, (tt.cores[0],)]}, found,
                       set())
    assert found == {torch.device("cpu")}
    t = StageTimer()
    with t.stage("tt", tt):
        pass
    t.start("sketch")
    assert t.stop("sketch", sk) >= 0
    t.start("many")
    t.stop("many", {"a": [tt, sk], "b": (1, None, "x")})
    assert profiling.block_until_ready(sk) is sk
    assert t.summary()["tt"]["count"] == 1


def test_trace_writes_profile(tmp_path):
    with profiling.trace(str(tmp_path)):
        _ = torch.ones((64, 64)) @ torch.ones((64, 64))
    files = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trace_perfetto_link_raises(tmp_path):
    with pytest.raises(ValueError, match="create_perfetto_link"):
        with profiling.trace(str(tmp_path), create_perfetto_link=True):
            pass
    assert not list(tmp_path.iterdir())


def test_memory_stats_on_the_cpu(monkeypatch):
    assert profiling.memory_stats() == {}
    assert profiling.memory_stats("cpu") == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.set_default_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.memory_stats()
