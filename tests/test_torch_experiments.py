"""The port's experiment harness (``tt_sketch_torch/experiments``) against the
JAX package's: the runner's resume answers on every committed
``results/*.csv`` and the CSVs it writes, the nine problem builders, the
nine tasks, the CLI (``list``, one quick driver, ``plot``), the recorded
``drm_stream`` divergence and the imports of the card's path.

Tolerances: problems and tasks 1e-10 relative (float64, the same draws,
sums in another order); CSV cells equal apart from ``time_taken``; figures'
line data equal.
"""
import csv
import inspect
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import tt_sketch_torch
from tt_sketch_torch import config
from tt_sketch_torch.drm import TensorTrainDRM
from tt_sketch_torch.experiments import Experiment, problems, tasks
from tt_sketch_torch.experiments import __main__ as cli
from tt_sketch_torch.experiments import plots
from tt_sketch_torch.experiments.runner import timed
from tt_sketch_torch.formats import TensorTrain
from tt_sketch_torch.interop import from_numpy_cores
from tt_sketch_tpu.drm import TensorTrainDRM as JTensorTrainDRM
from tt_sketch_tpu.experiments import Experiment as JExperiment
from tt_sketch_tpu.experiments import problems as jproblems
from tt_sketch_tpu.experiments import tasks as jtasks
from tt_sketch_tpu.experiments import __main__ as jcli
from tt_sketch_tpu.experiments import plots as jplots

ROOT = Path(__file__).resolve().parents[1]
RESULTS = sorted((ROOT / "results").glob("*.csv"))
TOL = 1e-10


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _dense(x):
    """A tensor of either package as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "to_dense"):
        return _dense(x.to_dense())
    return np.asarray(x, np.float64)


def _close(ours, ref, tol=TOL):
    a, b = _dense(ours), _dense(ref)
    assert a.shape == b.shape
    assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

def _python(value):
    return None if pd.isna(value) else (
        value.item() if hasattr(value, "item") else value)


@pytest.mark.parametrize("path", RESULTS, ids=lambda p: p.stem)
def test_is_done_answers_as_jax_on_every_committed_csv(path):
    ours, ref = Experiment(str(path)), JExperiment(str(path))
    frame = pd.read_csv(path)
    assert ours.columns == list(frame.columns)
    assert len(ours.data) == len(frame)
    keys = [c for c in frame.columns if c not in ("error", "time_taken")]
    for _, row in frame.iterrows():
        conds = {c: _python(row[c]) for c in keys}
        assert ours.is_done(conds) and ref.is_done(conds), conds
    # absent rows: an unseen seed, an unknown name, an unknown column, a
    # missing value asked for where the row has one, an integer where the
    # record has a float
    row = frame.iloc[len(frame) // 2]
    conds = {c: _python(row[c]) for c in keys}
    filled = [c for c in keys if conds[c] is not None and c != "name"]
    cases = [dict(conds, name="no-such-method"),
             dict(conds, no_such_column=1),
             dict(conds, **{filled[0]: None})]
    if "seed" in filled:
        cases.append(dict(conds, seed=-1))
    floats = [c for c in filled if isinstance(conds[c], float)
              and conds[c].is_integer()]
    if floats:
        cases.append(dict(conds, **{floats[0]: int(conds[floats[0]])}))
    for case in cases:
        assert ours.is_done(case) == ref.is_done(case), case


def _fake(inp, **kw):
    out = {"error": 0.125 * (1 + len(kw)), "time_taken": 0.5}
    if "extra" in kw:
        out["final"] = json.dumps([1.0, 2.5])
    return out


def _same_csv(ours_path, ref_path):
    ours = pd.read_csv(ours_path).drop(columns="time_taken")
    ref = pd.read_csv(ref_path).drop(columns="time_taken")
    pd.testing.assert_frame_equal(ours, ref)


def test_written_csv_equals_jax(tmp_path):
    ours = Experiment(str(tmp_path / "ours.csv"))
    ref = JExperiment(str(tmp_path / "ref.csv"))
    calls = [
        ("STTA", dict(left_rank=5, right_rank=10,
                      left_drm_type=TensorTrainDRM, dtype=torch.float32,
                      compile=True, run=0, seed=5063)),
        ("HMT", dict(rank=5, drm_type=TensorTrainDRM, dtype=None, run=0,
                     seed=5064)),
        ("STTA", dict(ranks=(3, 3, 3), right_ranks=(6, 6, 6), run=1,
                      seed=1.5, extra="a, b")),
        ("TT-SVD", dict(rank=5, error_func=_fake)),
    ]
    jcalls = [(n, {k: (JTensorTrainDRM if v is TensorTrainDRM
                       else np.dtype("float32") if v is torch.float32
                       else v) for k, v in kw.items()}) for n, kw in calls]
    for (name, kw), (_, jkw) in zip(calls, jcalls):
        assert ours.run(None, name, _fake, **kw) is not None
        assert ref.run(None, name, _fake, **jkw) is not None
    # the same calls again are skipped by both
    for (name, kw), (_, jkw) in zip(calls, jcalls):
        assert ours.run(None, name, _fake, **kw) is None
        assert ref.run(None, name, _fake, **jkw) is None
    _same_csv(tmp_path / "ours.csv", tmp_path / "ref.csv")
    frame = pd.read_csv(tmp_path / "ours.csv")
    assert list(frame["dtype"].iloc[:2].fillna("")) == ["float32", ""]
    assert frame["left_drm_type"].iloc[0] == "TensorTrainDRM"
    assert frame["error_func"].iloc[3] == "_fake"


@pytest.mark.parametrize("stem", ["frostt", "dimension_scaling", "cookie",
                                  "scaling"])
def test_resumed_committed_csv_extends_as_jax(tmp_path, stem):
    for d in ("ours", "ref"):
        (tmp_path / d).mkdir()
        shutil.copy(ROOT / "results" / f"{stem}.csv", tmp_path / d)
    ours = Experiment(str(tmp_path / "ours" / f"{stem}.csv"))
    ref = JExperiment(str(tmp_path / "ref" / f"{stem}.csv"))
    # a recorded row (seed 5063 of frostt is run 0 at rank 5) is skipped;
    # scaling.csv, written by another script, has integer columns and no
    # names
    frame = pd.read_csv(ROOT / "results" / f"{stem}.csv")
    if "name" in frame:
        first = {c: _python(frame.iloc[0][c]) for c in frame.columns
                 if c not in ("name", "error", "time_taken")}
        assert ours.run(None, frame.iloc[0]["name"], _fake, **first) is None
        assert ref.run(None, frame.iloc[0]["name"], _fake, **first) is None
    kw = dict(left_rank=7, run=99, seed=123, dtype=torch.float32,
              extra="x")
    jkw = dict(kw, dtype=np.dtype("float32"))
    assert ours.run(None, "NEW", _fake, **kw) is not None
    assert ref.run(None, "NEW", _fake, **jkw) is not None
    _same_csv(tmp_path / "ours" / f"{stem}.csv",
              tmp_path / "ref" / f"{stem}.csv")


def test_timed_returns_value_and_time():
    out = timed(lambda: [torch.ones(3), {"a": torch.zeros(2)}])
    assert out["time_taken"] >= 0.0
    assert float(out["value"][0].sum()) == 3.0


def test_experiment_is_a_top_level_name():
    assert tt_sketch_torch.Experiment is Experiment


# ---------------------------------------------------------------------------
# Problems and tasks
# ---------------------------------------------------------------------------

PROBLEMS = {
    "hilbert_problem": dict(n_dims=4, size=4),
    "sqrt_problem": dict(n_dims=3, dim=6),
    "tt_sum_problem": dict(n_dims=4, dim=5, tt_rank=2, num_tts=4),
    "tt_plus_sparse_problem": dict(n_dims=4, dim=5, tt_rank=2, nnz=20),
    "cp_problem": dict(n_dims=4, dim=5, cp_rank=7),
    "exp_decay_uniform_problem": dict(order=6, dim=5, rank=3),
    "dense_random_problem": dict(n_dims=3, dim=6),
    "exp_decay_tt_problem": dict(n_dims=5, dim=4, tt_rank=4),
    "timings_vs_error_problem": dict(n_dims=4, dim=6, tt_rank=3, num_tts=3),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_problem_equals_jax(name):
    ours = getattr(problems, name)(**PROBLEMS[name])
    ref = getattr(jproblems, name)(**PROBLEMS[name])
    if name == "exp_decay_uniform_problem":
        for a, b in zip(ours, ref):
            _close(a, b)
        return
    assert type(ours).__name__ == type(ref).__name__
    assert tuple(ours.shape) == tuple(ref.shape)
    _close(ours, ref)


def test_problems_built_on_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.set_default_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        problems.hilbert_problem(n_dims=3, size=3)
    assert problems.hilbert_problem(n_dims=3, size=3,
                                    device="cpu").device.type == "cpu"


def _hilbert_pair():
    return (problems.hilbert_problem(n_dims=4, size=4),
            jproblems.hilbert_problem(n_dims=4, size=4))


def _decay_pair():
    kw = dict(n_dims=5, dim=4, tt_rank=4, min_svdval=-3.0)
    return (problems.exp_decay_tt_problem(**kw),
            jproblems.exp_decay_tt_problem(**kw))


def _uniform_pair():
    kw = dict(order=6, dim=5, rank=3)
    return (problems.exp_decay_uniform_problem(**kw),
            jproblems.exp_decay_uniform_problem(**kw))


TASKS = {
    "experiment_stream_sketch": (_hilbert_pair, dict(left_rank=3,
                                                     right_rank=6, seed=3)),
    "experiment_orthogonal_sketch": (_hilbert_pair, dict(
        left_rank=3, right_rank=6, seed=4, recompression_rank=2)),
    "experiment_hmt_sketch": (_hilbert_pair, dict(rank=3, seed=5)),
    "experiment_tt_svd": (_hilbert_pair, dict(rank=3)),
    "experiment_tt_round": (_decay_pair, dict(rank=3)),
    "experiment_uniform_stream_sketch": (_uniform_pair, dict(
        left_rank=3, right_rank=6, recompression_rank=2, seed=6,
        drm_stream="hash")),
    "experiment_uniform_orthogonal_sketch": (_uniform_pair, dict(
        left_rank=3, right_rank=6, recompression_rank=2, seed=7,
        drm_stream="hash")),
    "experiment_uniform_tt_round": (_uniform_pair, dict(rank=2)),
    "experiment_uniform_hmt_sketch": (_uniform_pair, dict(
        rank=3, recompression_rank=2, seed=8, drm_stream="hash")),
}


@pytest.mark.parametrize("name", sorted(TASKS))
def test_task_equals_jax(name):
    make, kw = TASKS[name]
    ours_in, ref_in = make()
    ours = getattr(tasks, name)(ours_in, **kw)
    ref = getattr(jtasks, name)(ref_in, **kw)
    assert set(ours) == set(ref) == {"error", "time_taken"}
    assert ours["time_taken"] > 0
    assert abs(ours["error"] - ref["error"]) <= TOL * max(ref["error"], 1e-3)


def test_task_takes_any_dtype_spelling():
    t = problems.hilbert_problem(n_dims=3, size=4)
    errors = {str(d): tasks.experiment_stream_sketch(
        t, left_rank=2, right_rank=4, seed=1, dtype=d)["error"]
        for d in (None, torch.float64, np.float64, "float64")}
    assert len(set(errors.values())) == 1
    assert tasks.torch_dtype("float32") is torch.float32
    assert tasks.torch_dtype(np.dtype("float32")) is torch.float32


def test_uniform_tasks_default_to_the_torch_stream_and_jax_raises():
    """Recorded divergence: the JAX package's uniform tasks default to its
    ``"jax"`` DRM stream, which the port does not have; the port's default
    is ``"torch"``, and ``"jax"`` raises.  The drivers pass ``"hash"``."""
    for name in ("experiment_uniform_stream_sketch",
                 "experiment_uniform_orthogonal_sketch",
                 "experiment_uniform_hmt_sketch"):
        ours = inspect.signature(getattr(tasks, name))
        ref = inspect.signature(getattr(jtasks, name))
        assert ours.parameters["drm_stream"].default == "torch"
        assert ref.parameters["drm_stream"].default == "jax"
    stacked = problems.exp_decay_uniform_problem(6, 5, 3)
    a = tasks.experiment_uniform_hmt_sketch(stacked, rank=3, seed=2)
    b = tasks.experiment_uniform_hmt_sketch(stacked, rank=3, seed=2)
    assert a["error"] == b["error"]
    with pytest.raises(ValueError, match="jax"):
        tasks.experiment_uniform_hmt_sketch(stacked, rank=3, seed=2,
                                            drm_stream="jax")


def test_exp_decay_tt_problem_draws_on_the_host():
    tt = problems.exp_decay_tt_problem(n_dims=4, dim=4, tt_rank=3)
    ref = jproblems.exp_decay_tt_problem(n_dims=4, dim=4, tt_rank=3)
    ours = TensorTrain(from_numpy_cores([np.asarray(c) for c in ref.cores]))
    assert abs(tt.error(ours, relative=True)) <= TOL


# ---------------------------------------------------------------------------
# The CLI and the figures
# ---------------------------------------------------------------------------

def test_cli_list_equals_jax(capsys):
    assert cli.main(["list"]) == 0
    ours = capsys.readouterr().out.split()
    assert jcli.main(["list"]) == 0
    assert ours == capsys.readouterr().out.split()
    assert len(ours) == 13


def test_cli_runs_as_a_module_without_pandas_or_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['x', 'list']\n"
            "runpy.run_module('tt_sketch_torch.experiments', "
            "run_name='__main__')\n")
    check = ("import sys, tt_sketch_torch.experiments.__main__, "
             "tt_sketch_torch.experiments.drivers\n"
             "bad = [m for m in ('pandas', 'jax', 'tt_sketch_tpu', "
             "'matplotlib') if m in sys.modules]\n"
             "assert not bad, bad\n")
    for snippet in (code, check):
        out = subprocess.run([sys.executable, "-c", snippet], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
    assert "hilbert" in subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120).stdout.split()


def test_cli_quick_driver_equals_jax(tmp_path, capsys):
    args = ["dimension_scaling_gaussian", "--quick", "--no-progress",
            "--platform", "cpu"]
    assert cli.main(args + ["--out", str(tmp_path / "ours")]) == 0
    assert jcli.main(args + ["--out", str(tmp_path / "ref")]) == 0
    assert "10 rows" in capsys.readouterr().out
    ours = pd.read_csv(tmp_path / "ours" / "dimension_scaling_gaussian.csv")
    ref = pd.read_csv(tmp_path / "ref" / "dimension_scaling_gaussian.csv")
    assert list(ours.columns) == list(ref.columns)
    keys = [c for c in ref.columns if c not in ("error", "time_taken")]
    pd.testing.assert_frame_equal(ours[keys], ref[keys])
    np.testing.assert_allclose(ours["error"], ref["error"], rtol=1e-8,
                               atol=1e-14)
    # resumed: nothing runs again
    assert cli.main(args + ["--out", str(tmp_path / "ours")]) == 0
    assert len(pd.read_csv(tmp_path / "ours" /
                           "dimension_scaling_gaussian.csv")) == 10


def _figure_lines(monkeypatch, render):
    """The line and collection data of every figure ``render`` saves."""
    import matplotlib.figure

    seen = []

    def savefig(fig, *args, **kwargs):
        for ax in fig.axes:
            seen.append(("title", ax.get_title(), ax.get_xlabel(),
                         ax.get_xscale(), ax.get_yscale()))
            for line in ax.get_lines():
                seen.append((line.get_label(),
                             np.asarray(line.get_xdata(), float).tolist(),
                             np.asarray(line.get_ydata(), float).tolist()))
            for coll in ax.collections:
                seen.append(np.asarray(coll.get_offsets(), float).tolist()
                            if hasattr(coll, "get_offsets") else None)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    render()
    return seen


@pytest.mark.parametrize("stem", ["hilbert", "cookie", "dimension_scaling"])
def test_plot_line_data_equals_jax(tmp_path, monkeypatch, capsys, stem):
    shutil.copy(ROOT / "results" / f"{stem}.csv", tmp_path)
    ours = _figure_lines(monkeypatch, lambda: cli.main(
        ["plot", stem, "--out", str(tmp_path)]))
    ref = _figure_lines(monkeypatch, lambda: jcli.main(
        ["plot", stem, "--out", str(tmp_path)]))
    assert ours and ours == ref
    assert f"{stem}.png" in capsys.readouterr().out
    assert plots._PLOT_CONFIG == jplots._PLOT_CONFIG


def test_csv_without_pandas_reads_what_pandas_reads():
    """The runner's own reader gives every committed CSV's cells as
    ``pandas.read_csv`` does (missing cells as None).  pandas' default float
    parser keeps about 14 significant digits of a long cell
    (0.004360176254431149 reads as 0.0043601762544311); its exact one,
    ``round_trip``, is Python's, which the runner uses."""
    for path in RESULTS:
        exp = Experiment(str(path))
        frame = pd.read_csv(path, float_precision="round_trip")
        for col in frame.columns:
            theirs = [_python(v) for v in frame[col]]
            ours = exp.column(col)
            assert [v is None for v in ours] == [v is None for v in theirs]
            assert all(a == b for a, b in zip(ours, theirs)
                       if a is not None), col
        with open(path, newline="") as f:
            assert next(csv.reader(f)) == exp.columns
