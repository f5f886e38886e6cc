"""The projector diagnostics of the port (``kernels/projector_diag.py``)
against the measurement kernels of ``scripts/bench_projector_diag.py``.

The script's Pallas kernels run in interpret mode
(``pltpu.force_tpu_interpret_mode()``) at shapes their blocks divide
(``bm=32, bn=128``); the script is loaded from its file and not edited.
Tolerance: ``2e-5·max|ref|`` for f32 and bf16 alike (fp32 sums of at most
512 terms in another order; in bf16 mode both sides round the same
operands to bfloat16 and their products are exact in fp32).  On ragged
shapes the TPU kernels are not defined; those tests record the divergence.
"""
import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tt_sketch_torch import config, profiling
from tt_sketch_torch.kernels import dual_project as dp
from tt_sketch_torch.kernels import projector_diag as PD

ROOT = Path(__file__).resolve().parents[1]
BLOCKS = dict(bm=32, bn=128)
SHAPES = [(64, 256, 4, 8), (128, 512, 8, 16)]
TOL = 2e-5
KERNELS = {"t_only": (PD.t_only, PD.t_only_reference),
           "u_only": (PD.u_only, PD.u_only_reference),
           "reduce_read": (PD.reduce_read, PD.reduce_read_reference)}


def _launches(wrapper):
    """The launches counted for kernel wrapper ``wrapper`` so far."""
    return profiling.counters().get(f"launches.{wrapper}", 0)


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "bench_projector_diag", ROOT / "scripts" / "bench_projector_diag.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


def _operands(P, S, r, rho, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((P, S)).astype(dtype),
            rng.standard_normal((S, rho)).astype(dtype),
            rng.standard_normal((P, r)).astype(dtype))


def _pallas(script, name, X, side=None, compute="f32", **kw):
    mxu = {"f32": jnp.float32, "bf16": jnp.bfloat16}[compute]
    fn = getattr(script, name)
    with pltpu.force_tpu_interpret_mode():
        if name == "reduce_read":
            return np.asarray(fn(X, **BLOCKS))
        return np.asarray(fn(X, side, mxu=mxu, **BLOCKS, **kw))


def _port(name, X, side=None, compute="f32"):
    fn = KERNELS[name][0]
    if name == "reduce_read":
        return fn(torch.from_numpy(X)).numpy()
    return fn(torch.from_numpy(X), torch.from_numpy(side), compute).numpy()


def _side(name, R, L):
    return {"t_only": R, "u_only": L, "reduce_read": None}[name]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name, compute", [
    ("t_only", "f32"), ("t_only", "bf16"), ("u_only", "f32"),
    ("u_only", "bf16"), ("reduce_read", "f32")])
def test_matches_the_scripts_pallas_kernel(script, name, compute, shape):
    X, R, L = _operands(*shape)
    side = _side(name, R, L)
    ref = _pallas(script, name, X, side, compute)
    before = _launches(name)
    got = _port(name, X, side, compute)
    assert _launches(name) == before  # CPU: the plain version
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())


def test_run_projector_diag_on_cpu_takes_the_plain_versions(capsys):
    X, R, L = (torch.from_numpy(a) for a in _operands(64, 256, 5, 9, seed=1))
    before = {n: _launches(n) for n in KERNELS}
    before_dual = _launches("dual_project")
    res = PD.run_projector_diag(X, R, L, reps=2)
    assert tuple(res) == PD.TAGS == (
        "read-roofline", "lib-T", "lib-U", "T-f32", "T-bf16", "U-f32",
        "U-bf16", "dual-f32", "dual-bf16")
    want = {
        "read-roofline": PD.reduce_read_reference(X),
        "lib-T": X @ R, "lib-U": L.T @ X,
        "T-f32": PD.t_only_reference(X, R),
        "T-bf16": PD.t_only_reference(X, R, "bf16"),
        "U-f32": PD.u_only_reference(X, L),
        "U-bf16": PD.u_only_reference(X, L, "bf16"),
        "dual-f32": dp.dual_project_reference(X, R, L),
        "dual-bf16": dp.dual_project_reference(X, R, L, "bf16"),
    }
    for tag, ref in want.items():
        got = res[tag]["out"]
        for g, w in zip(*((o,) if torch.is_tensor(o) else o
                          for o in (got, ref))):
            assert torch.equal(g, w), tag
        assert res[tag]["ms"] > 0
        assert res[tag]["gbps"] == pytest.approx(
            X.numel() * 4 / (res[tag]["ms"] / 1e3) / 1e9)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == [f"[{t}]" for t in PD.TAGS]
    assert all(ln.split()[2] == "ms" and ln.endswith("GB/s") for ln in lines)
    assert {n: _launches(n) for n in KERNELS} == before
    assert _launches("dual_project") == before_dual
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_main_runs_at_the_main_shape_on_the_card_only(monkeypatch):
    # python -m tt_sketch_torch.kernels.projector_diag: the main-path slab
    # view on the card; without one it exits before making any operand
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        PD.main()
    assert PD.MAIN_SHAPE == (32768, 16384, 32, 64)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_raises_off_cpu_without_kernel(name):
    # a tensor that is neither on the CPU nor on CUDA never reaches the
    # plain version: the wrapper launches or raises
    fn = KERNELS[name][0]
    X = torch.empty((64, 128), device="meta")
    side = {"t_only": torch.empty((128, 8), device="meta"),
            "u_only": torch.empty((64, 4), device="meta")}.get(name)
    args = (X,) if side is None else (X, side)
    before = _launches(name)
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*args)
    if side is not None:
        with pytest.raises(ValueError, match="compute"):
            fn(*args, compute="tf32")
        # one operand on the CPU and one elsewhere is not the plain path
        with pytest.raises(ValueError, match="CUDA device"):
            fn(torch.zeros((64, 128)), side)
    assert _launches(name) == before


@pytest.mark.parametrize("name, step, dim, width", [
    ("t_only", 64, 1, 100), ("u_only", 32, 0, 40), ("t_only", 64, 1, 64),
    ("u_only", 32, 0, 0)])
def test_rank_split_equals_one_launch_through_the_plain_path(name, step,
                                                             dim, width):
    # the wrappers split a rank above the kernel's per-launch limit into
    # column blocks with in_rank_blocks; through the plain version the
    # blocks give the one-launch result
    X, R, L = (torch.from_numpy(a) for a in
               _operands(50, 90, width, width, seed=2, dtype=np.float64))
    side = R if name == "t_only" else L
    plain = KERNELS[name][1]
    blocks = []

    def block(side_c):
        blocks.append(side_c.shape[1])
        return plain(X, side_c)

    split = PD.in_rank_blocks(block, side, step, dim)
    assert blocks == ([min(step, width - c) for c in range(0, width, step)]
                      or [0])
    np.testing.assert_allclose(split.numpy(), plain(X, side).numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("P, S", [(64, 200), (48, 256)])
def test_ragged_shapes_port_takes_all_tpu_kernels_do_not(script, P, S):
    # recorded divergence: the port's kernels mask ragged edges and compute
    # the whole product; the TPU kernels (bm=32, bn=128) drop the column
    # tail past 128 or leave NaN where no block wrote
    X, R, L = _operands(P, S, 4, 8, seed=3)
    for name in KERNELS:
        side = _side(name, R, L)
        got = _port(name, X, side)
        full = {"t_only": X @ R, "u_only": L.T @ X,
                "reduce_read": X.sum(1, keepdims=True)}[name]
        np.testing.assert_allclose(got, full, rtol=0,
                                   atol=TOL * np.abs(full).max())
    T, U, s = (_pallas(script, n, X, _side(n, R, L)) for n in KERNELS)
    if S == 200:  # columns 128..199 of X are never read
        cut = X[:, :128]
        np.testing.assert_allclose(T, cut @ R[:128], atol=1e-4)
        np.testing.assert_allclose(s, cut.sum(1, keepdims=True), atol=1e-4)
        assert np.isnan(U[:, 128:]).all() and np.isfinite(U[:, :128]).all()
    else:  # rows 32..47 of X are never read
        assert np.isnan(T[32:]).all() and np.isfinite(T[:32]).all()
        assert np.isnan(s[32:]).all()
        np.testing.assert_allclose(U, L[:32].T @ X[:32], atol=1e-4)


def test_no_counterpart_of_the_megacore_switch(script):
    # recorded divergence: the script's sem="parallel" sets TPU megacore
    # dimension semantics; it changes the schedule, not the result, and the
    # H100 has no such switch, so the port's t_only takes no ``sem``
    X, R, _ = _operands(64, 256, 4, 8, seed=4)
    par = _pallas(script, "t_only", X, R, sem="parallel")
    arb = _pallas(script, "t_only", X, R, sem="arbitrary")
    np.testing.assert_array_equal(par, arb)
    np.testing.assert_allclose(_port("t_only", X, R), par, rtol=0,
                               atol=TOL * np.abs(par).max())
    assert "sem" not in inspect.signature(PD.t_only).parameters
    assert not any("parallel" in t for t in PD.TAGS)


def test_dual_project_block_sweep_is_not_carried_over():
    # recorded divergence: the script sweeps the TPU kernel's (bm, bn); the
    # port's tiles are fixed, so its dual_project takes no block sizes and
    # the diagnostics time it once per compute mode
    from tt_sketch_tpu.kernels.pallas_project import dual_project as j_dual

    X, R, L = _operands(128, 512, 8, 16, seed=5)
    T, U = dp.dual_project(*(torch.from_numpy(a) for a in (X, R, L)))
    for bm, bn in ((32, 128), (64, 256)):
        T0, U0 = (np.asarray(o) for o in j_dual(
            jnp.asarray(X), jnp.asarray(R), jnp.asarray(L), block_m=bm,
            block_n=bn, interpret=True))
        for a, b in ((T, T0), (U, U0)):
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=TOL * np.abs(b).max())
    params = inspect.signature(dp.dual_project).parameters
    assert not {"block_m", "block_n"} & set(params)
    assert [t for t in PD.TAGS if t.startswith("dual")] == ["dual-f32",
                                                            "dual-bf16"]


@pytest.mark.parametrize("P, S, r, rho", [(1000, 3000, 7, 13),
                                          (777, 5000, 40, 100)])
def test_kernels_match_plain_versions_on_the_card(cuda_card, P, S, r, rho):
    g = torch.Generator(device="cuda").manual_seed(0)
    X, R, L = (torch.randn(s, generator=g, device="cuda")
               for s in ((P, S), (S, rho), (P, r)))
    # bf16 too: both sides round the same operands and accumulate in fp32
    for compute in ("f32", "bf16"):
        for got, ref in ((PD.t_only(X, R, compute),
                          PD.t_only_reference(X, R, compute)),
                         (PD.u_only(X, L, compute),
                          PD.u_only_reference(X, L, compute))):
            assert float(torch.linalg.norm(got - ref)
                         / torch.linalg.norm(ref)) <= 2e-5
    got, ref = PD.reduce_read(X), PD.reduce_read_reference(X)
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) <= 2e-5
