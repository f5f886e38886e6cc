"""The batched Jacobi SVD kernel (``csrc/jacobi_svd.cu``) on a CUDA card,
against its plain version, numpy's float64 SVD and solve, and
``torch.linalg.svd``; and the recovery that uses it: ``to_tt()`` of a
small STTA sketch and of a small dense sketch with no host sync, one
launch and no fallback.

This file imports no JAX, so that it runs on a machine with a card:
``python3 -m pytest --noconftest tests/test_torch_jacobi_svd_card.py``.
Without a card every test skips.

Tolerances.  Singular values within ``1e-12·σ_max`` of numpy's in float64
and ``2e-5·σ_max`` in float32 (the plain version's CPU test: measured
≤ 7.5e-15 and ≤ 2.5e-6).  Float64 solutions as in the CPU test (relative
``1e-12``, ``1e-9`` at cond 1e6).  Float32 solutions against the solve over
``torch.linalg.svd``'s factors on the card (the solve the kernel
replaced): relative ``1e-4``, and ``3e-2`` at cond 1e6, where either is
within about cond·eps ≈ 0.1 of the exact solution (the plain version
measured 1.1e-5 and 2.3e-3).  Recovered TTs: relative Frobenius ``1e-3`` against the same
sketch recovered on the CPU.
"""
import numpy as np
import pytest
import torch

from jacobi_svd_cases import KINDS, SHAPES, matrices, rhs, truncated_solve
from tt_sketch_torch import SparseGaussianDRM, profiling, stream_sketch
from tt_sketch_torch import utils as tu
from tt_sketch_torch.engine.sketch import assemble_sketched_tt
from tt_sketch_torch.engine.sketch_container import SketchContainer
from tt_sketch_torch.formats import DenseTensor, SparseTensor, TensorTrain
from tt_sketch_torch.kernels import jacobi_svd as JS

EPS = {torch.float64: np.finfo(np.float64).eps,
       torch.float32: np.finfo(np.float32).eps}
SV_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
SOLVE_TOL = {torch.float64: {"well": 1e-12, "cond_1e6": 1e-9,
                             "rank_noise": 1e-12, "wide": 1e-12},
             torch.float32: {"well": 1e-4, "cond_1e6": 3e-2,
                             "rank_noise": 1e-4, "wide": 1e-4}}
TT_TOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")


def _delta(before, name):
    return profiling.counters().get(name, 0) - before.get(name, 0)


def _svd_checks(A, U, s, Vh, used, tol):
    s_np = np.linalg.svd(A.double().cpu().numpy(), compute_uv=False)
    top = max(float(s_np.max()), 1e-300)
    assert float(np.abs(s.double().cpu().numpy() - s_np).max()) <= tol * top
    assert bool((s[..., :-1] >= s[..., 1:]).all())
    rec = (U * s[..., None, :]) @ Vh
    assert float((rec - A).abs().max()) <= 100 * EPS[A.dtype] * top * max(
        A.shape[-2:])
    assert int(used.max()) <= JS.MAX_SWEEPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_against_plain_numpy_and_library(card, shape, kind, dtype):
    A = torch.from_numpy(matrices(kind, shape, EPS[dtype])).to(
        "cuda", dtype)
    before = profiling.counters()
    U, s, Vh, used = JS.jacobi_svd(A, return_sweeps=True)
    torch.cuda.synchronize()
    assert _delta(before, "launches.jacobi_svd") == 1
    assert U.dtype == s.dtype == Vh.dtype == dtype
    _svd_checks(A, U, s, Vh, used, SV_TOL[dtype])
    pU, ps, pVh = JS.jacobi_svd_reference(A.cpu())
    top = max(float(ps.abs().max()), 1e-300)
    assert float((s.cpu() - ps).abs().max()) <= 2 * SV_TOL[dtype] * top
    if kind == "zero":
        assert int(used.max()) == 1 and not bool(s.any())
        assert bool(torch.isfinite(U).all() and torch.isfinite(Vh).all())
        return
    m, n = A.shape[-2:]
    B = rhs(A.cpu().double().numpy())
    Bt = torch.from_numpy(B).to("cuda", dtype)
    before = profiling.counters()
    x = tu._lstsq(A, Bt)
    assert _delta(before, "launches.jacobi_svd") == 1
    assert _delta(before, "fallbacks.lstsq_svd") == 0
    if dtype == torch.float64:
        ref = truncated_solve(A.cpu().numpy(), B)
    else:  # the solve over torch.linalg.svd on the card
        LU, Ls, LVh = torch.linalg.svd(A, full_matrices=False)
        ref = tu._solve(LU, tu._inverted(Ls, m, n), LVh, Bt).cpu().numpy()
    err = np.linalg.norm(x.cpu().numpy() - ref) / np.linalg.norm(ref)
    assert err <= SOLVE_TOL[dtype][kind], err


@pytest.mark.parametrize("kind, seed", [("well", 3), ("cond_1e6", 0),
                                        ("cond_1e6", 1)])
def test_batch_of_8190_float64(card, kind, seed):
    """The uniform engine's edges: the pivoted QR brings the sweeps to 7-10
    (12 at cond 1e6 on an unpivoted R^T), one below the cap at least."""
    A = torch.from_numpy(matrices(kind, (8190, 30, 30), EPS[torch.float64],
                                  seed)).cuda()
    before = profiling.counters()
    U, s, Vh, used = JS.jacobi_svd(A, return_sweeps=True)
    torch.cuda.synchronize()
    assert _delta(before, "launches.jacobi_svd") == 1
    _svd_checks(A, U, s, Vh, used, 1e-12)
    assert int(used.max()) <= JS.MAX_SWEEPS - 1


@pytest.mark.parametrize("elem, dtype", [(4, torch.float32),
                                         (8, torch.float64)])
@pytest.mark.parametrize("n", [1, 2, 7, 16, 17, 20, 32, 33, 34, 35, 62, 63,
                               64])
def test_c_fit_agrees_with_jacobi_fits(card, elem, dtype, n):
    lib = JS._library()
    m = n
    while JS.smem_bytes(elem, m + 1, n) <= JS.SMEM_BUDGET:
        m += 1
    for rows in (n, m, m + 1):
        assert bool(lib.tt_jacobi_svd_fits(elem, rows, n)) == \
            JS.jacobi_fits(rows, n, dtype), rows
        assert lib.tt_jacobi_svd_smem(elem, rows, n) == JS.smem_bytes(
            elem, rows, n)
    assert not lib.tt_jacobi_svd_fits(elem, n - 1, n)  # m >= n only


def test_non_finite_matrix_gives_non_finite_output_and_no_sync(card):
    A = torch.from_numpy(matrices("well", (3, 40, 20), 0.0)).float().cuda()
    A[1, 5, 7] = float("nan")
    clean = JS.jacobi_svd(A[[0, 2]])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        U, s, Vh = tu._svd(A)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isnan(s[1]).any())
    for got, want in zip((U, s, Vh), clean):
        assert torch.equal(got[[0, 2]], want)


def test_beyond_the_fit_falls_back_to_the_library(card):
    A = torch.randn((2, 100, 80), device="cuda")
    before = profiling.counters()
    U, s, Vh = tu._svd(A)
    assert _delta(before, "fallbacks.lstsq_svd") == 1
    assert _delta(before, "launches.jacobi_svd") == 0
    ref = torch.linalg.svdvals(A)
    assert float((s - ref).abs().max() / ref.max()) <= 1e-5


def _stta_sketch():
    """A float32 COO tensor with uber's ranks (Ω 20 x 40), sketched on the
    card with Gaussian DRMs."""
    shape = (183, 24, 60, 50)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, n, 20_000) for n in shape])
    t = SparseTensor(shape, idx, rng.standard_normal(20_000).astype(
        np.float32))
    return stream_sketch(t, 20, 40, seed=1, left_drm_type=SparseGaussianDRM,
                         right_drm_type=SparseGaussianDRM,
                         dtype=torch.float32)


def _dense_sketch():
    """A float32 dense tensor with the dense stream's ranks (Ω 32 x 64),
    sketched on the card with TT-DRMs."""
    X = TensorTrain.random((64, 8, 8, 64), 5, seed=0).to_dense().float()
    return stream_sketch(DenseTensor(X.cuda()), 32, 64, seed=2,
                         dtype=torch.float32)


@pytest.mark.parametrize("make, omega", [(_stta_sketch, (20, 40)),
                                         (_dense_sketch, (32, 64))])
def test_to_tt_makes_no_sync_and_one_launch(card, make, omega):
    sk = make()
    assert {tuple(O.shape) for O in sk.Omega_mats} == {omega}
    torch.cuda.synchronize()
    before = profiling.counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tt = sk.to_tt()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _delta(before, "launches.jacobi_svd") == 1
    assert _delta(before, "fallbacks.lstsq_svd") == 0
    host = SketchContainer([P.cpu() for P in sk.Psi_cores],
                           [O.cpu() for O in sk.Omega_mats])
    ref = TensorTrain(assemble_sketched_tt(host)).to_dense()
    got = tt.to_dense().cpu()
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) \
        <= TT_TOL
