"""``correct`` comes out false where it must: the control (the plain
reference in the precision just below float32, in the program's place)
fails the limits, and a whole run with the timed path broken underneath
(half of the work left out and the rest doubled, a state left unchanged,
one value altered where it is produced) reads not correct.  At tiny sizes
on the CPU, skipping the harness's look for a card; the readings at the
cells' own sizes are in PERF.md."""
import pytest
import torch

from ttbench import calibrate, check, harness
from ttbench.tests import tiny


@pytest.fixture()
def folder(tmp_path):
    tiny.write_coo(tmp_path)
    return tmp_path


def run(name, folder):
    return harness.run(tiny.cell(name), 17, 0.05, False, "cpu", repo=folder)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_a_sound_run_is_correct(name, folder):
    result = run(name, folder)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("name", tiny.CELLS)
def test_the_control_is_not_correct(name, folder):
    cell = tiny.cell(name)
    limits = cell.traffic["check"]["limits"]
    rows = list(calibrate.readings(cell, 1, 3, "cpu", repo=folder))
    assert check.verdict(rows[0], limits)  # the program passes
    for row in rows[1:]:
        assert row["side"] == "control"
        assert not check.verdict({k: row[k] for k in limits}, limits)


def _half_slabs(orig):
    def fake(slab_fn, n_slabs, *args, **kw):
        return orig(lambda i: slab_fn(i) * 2 if i % 2 == 0
                    else slab_fn(i) * 0, n_slabs, *args, **kw)
    return fake


def _first_slab_only(orig):
    def fake(slab_fn, n_slabs, *args, **kw):
        return orig(lambda i: slab_fn(i) if i == 0 else slab_fn(i) * 0,
                    n_slabs, *args, **kw)
    return fake


def _altered_psi(orig):
    def fake(*args, **kw):
        out = orig(*args, **kw)
        p = out.Psi_cores[1]
        p[0, 0, 0] += p.abs().max()
        return out
    return fake


def _half_nonzeros(orig):
    def fake(tensor, *args, **kw):
        from tt_sketch_torch.formats.sparse import SparseTensor

        half = SparseTensor(tensor.shape, tensor.indices[:, ::2],
                            tensor.entries[::2] * 2).with_psi_plan(
            threshold=12)
        return orig(half, *args, **kw)
    return fake


DENSE = [("slab_stream_sketch", _half_slabs),
         ("slab_stream_sketch", _first_slab_only),
         ("slab_stream_sketch", _altered_psi)]
SPARSE = [("general_sketch", _half_nonzeros),
          ("general_sketch", _altered_psi)]


@pytest.mark.parametrize("name,target,fault", [
    ("dense-1e10.stream", t, f) for t, f in DENSE] + [
    (c, t, f) for c in tiny.CELLS[1:] for t, f in SPARSE])
def test_a_broken_timed_path_is_not_correct(name, target, fault, folder,
                                            monkeypatch):
    import tt_sketch_torch.engine.sketch as sketch
    import tt_sketch_torch.kernels.dense_engine as dense_engine

    module = dense_engine if target == "slab_stream_sketch" else sketch
    monkeypatch.setattr(module, target, fault(getattr(module, target)))
    result = run(name, folder)
    assert result["failed"] == 0
    assert not result["correct"]


def test_a_failed_request_is_counted_and_not_correct(folder, monkeypatch):
    import tt_sketch_torch.engine.sketch as sketch

    calls = []
    first_timed = int(tiny.cell("frostt-uber.stta").traffic["warmup"]) + 1

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == first_timed:
            raise RuntimeError("lost")
        return orig(*args, **kw)

    orig = sketch.general_sketch
    monkeypatch.setattr(sketch, "general_sketch", flaky)
    result = run("frostt-uber.stta", folder)
    assert result["failed"] == 1 and not result["correct"]


def test_the_card_runs_a_tiny_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        tiny.write_coo(Path(d))
        for name in tiny.CELLS:
            r = harness.run(tiny.cell(name), 3, 0.2, True, "cuda",
                            repo=Path(d))
            assert r["correct"] and r["device"]["busy_s"] > 0
