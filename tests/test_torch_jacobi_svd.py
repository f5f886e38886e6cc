"""The batched Jacobi SVD's plain version (``kernels/jacobi_svd``) on the
CPU, the routing of ``utils._svd`` / ``lstsq_each`` and the recovery's bits.

- The plain version against ``numpy.linalg.svd`` and numpy's truncated-SVD
  solve, in float64: singular values within ``1e-12·σ_max`` (measured
  ≤ 7.5e-15), solutions within relative ``1e-12`` (``1e-9`` at cond 1e6:
  its error bound is cond·eps·m ≈ 1.4e-8; measured ≤ 2.6e-11); the zero
  matrix's SVD only (the rcond rule, unchanged, keeps a zero σ_max).  In
  float32 the sweeps, and the singular values within ``2e-5·σ_max``
  (measured ≤ 2.5e-6).  Every matrix converges within ``MAX_SWEEPS``.
- The batch case at 1,024 float64 30 x 30 matrices (8,190 on the card),
  standard normal and at cond 1e6 (two sweeps to spare there).
- ``jacobi_fits`` at, below and beyond its limits.
- ``assemble_sketched_tt`` on the CPU: the same bits as the per-mode
  ``right_mul_pinv`` / ``left_mul_pinv`` recovery, in both directions, with
  Ω of differing shapes and with Ω of one shape (factored as one stack).
- ``lstsq_each`` on the CPU: one stacked SVD, the bits of ``_lstsq`` per
  system.
- ``lstsq_each`` off the CPU (on the meta device): one SVD call for the Ω
  of one shape, counted as a fallback there (no Jacobi on meta).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jacobi_svd_cases import KINDS, SHAPES, matrices, rhs, truncated_solve
from tt_sketch_torch import config, profiling
from tt_sketch_torch import utils as tu
from tt_sketch_torch.engine.sketch import assemble_sketched_tt
from tt_sketch_torch.engine.sketch_container import SketchContainer
from tt_sketch_torch.kernels import jacobi_svd as JS
from tt_sketch_tpu.kernels.accurate_linalg import jacobi_svd as jax_jacobi

EPS = {torch.float64: np.finfo(np.float64).eps,
       torch.float32: np.finfo(np.float32).eps}
SOLVE_TOL = {"well": 1e-12, "cond_1e6": 1e-9, "rank_noise": 1e-12,
             "wide": 1e-12}


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _svd_checks(A, U, s, Vh, used, sv_tol):
    """s against numpy's within ``sv_tol·σ_max``, descending; A = U s Vh;
    U's columns orthonormal where s > 0; every matrix converged."""
    s_np = np.linalg.svd(A.double().numpy(), compute_uv=False)
    top = max(float(s_np.max()), 1e-300)
    assert float(np.abs(s.double().numpy() - s_np).max()) <= sv_tol * top
    assert bool((s[..., :-1] >= s[..., 1:]).all())
    rec = (U * s[..., None, :]) @ Vh
    assert float((rec - A).abs().max()) <= 100 * EPS[A.dtype] * top * max(
        A.shape[-2:])
    assert int(used.max()) <= JS.MAX_SWEEPS


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_against_numpy_float64(shape, kind):
    A = torch.from_numpy(matrices(kind, shape, EPS[torch.float64]))
    U, s, Vh, used = JS.jacobi_svd_reference(A, return_sweeps=True)
    m, n = A.shape[-2:]
    assert U.shape == (3, m, min(m, n)) and Vh.shape == (3, min(m, n), n)
    _svd_checks(A, U, s, Vh, used, 1e-12)
    if kind == "zero":
        assert int(used.max()) == 1 and not bool(s.any())
        return
    B = rhs(A.numpy())
    x = tu._solve(U, tu._inverted(s, m, n), Vh, torch.from_numpy(B))
    ref = truncated_solve(A.numpy(), B)
    assert np.linalg.norm(x.numpy() - ref) <= SOLVE_TOL[kind] * np.linalg.norm(
        ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_float32_sweeps_and_values(shape, kind):
    A = torch.from_numpy(matrices(kind, shape, EPS[torch.float32])).float()
    U, s, Vh, used = JS.jacobi_svd_reference(A, return_sweeps=True)
    assert s.dtype == U.dtype == Vh.dtype == torch.float32
    _svd_checks(A, U, s, Vh, used, 2e-5)


@pytest.mark.parametrize("kind", ["well", "cond_1e6"])
def test_plain_version_batch_float64(kind):
    """The uniform engine's float64 30 x 30: the pivoted QR leaves two
    sweeps to spare at least (7-10; unpivoted, the sweeps on R^T reached
    12 at cond 1e6)."""
    A = torch.from_numpy(matrices(kind, (1024, 30, 30), EPS[torch.float64],
                                  seed=3))
    U, s, Vh, used = JS.jacobi_svd_reference(A, return_sweeps=True)
    _svd_checks(A, U, s, Vh, used, 1e-12)
    assert int(used.max()) <= JS.MAX_SWEEPS - 2


@pytest.mark.parametrize("shape", [(40, 20), (64, 32), (9, 7), (5, 1)])
def test_plain_version_matches_the_jax_function(shape):
    """On well-conditioned matrices (where the JAX function's fixed 12
    sweeps without a QR have converged): the same factorisation."""
    A = np.random.default_rng(8).standard_normal(shape)
    U, s, Vh = JS.jacobi_svd_reference(torch.from_numpy(A))
    jU, js, jV = (np.asarray(t) for t in jax_jacobi(jnp.asarray(A)))
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-13, atol=0)
    # singular vectors up to sign
    signs = np.sign(np.sum(U.numpy() * jU, axis=0))
    np.testing.assert_allclose(U.numpy() * signs, jU, atol=1e-12)
    np.testing.assert_allclose(Vh.numpy().T * signs, jV, atol=1e-12)


def test_plain_version_non_finite_input_gives_non_finite_output():
    A = torch.from_numpy(matrices("well", (2, 40, 20), 0.0))
    A[1, 3, 4] = float("nan")
    U, s, Vh = JS.jacobi_svd_reference(A)
    assert bool(torch.isfinite(s[0]).all()) and bool(torch.isnan(s[1]).any())
    x = tu._solve(U, tu._inverted(s, 40, 20), Vh, torch.ones(2, 40, 3,
                                                             dtype=A.dtype))
    assert bool(torch.isfinite(x[0]).all()) and not bool(
        torch.isfinite(x[1]).all())


@pytest.mark.parametrize("n_p", [2, 4, 20, 32, 62])
def test_round_robin_pairs_every_column_pair_once(n_p):
    rounds = JS.round_robin(n_p)
    assert rounds.shape == (n_p - 1, n_p // 2, 2)
    for pairs in rounds.tolist():
        assert sorted(c for p in pairs for c in p) == list(range(n_p))
    seen = {tuple(sorted(p)) for pairs in rounds.tolist() for p in pairs}
    assert len(seen) == n_p * (n_p - 1) // 2


@pytest.mark.parametrize("m, n, dtype, fits", [
    (40, 20, torch.float32, True), (64, 32, torch.float32, True),
    (32, 64, torch.float32, True), (30, 30, torch.float64, True),
    (64, 32, torch.float64, True),
    (62, 62, torch.float32, True), (63, 63, torch.float32, False),
    (34, 34, torch.float64, True), (35, 35, torch.float64, False),
    (2000, 64, torch.float32, False), (70, 65, torch.float32, False),
    (1, 1, torch.float32, True), (0, 5, torch.float32, False),
    (5, 0, torch.float64, False),
    (64, 32, torch.float16, False), (64, 32, torch.bfloat16, False),
    (64, 32, torch.complex64, False)])
def test_jacobi_fits_limits(m, n, dtype, fits):
    assert JS.jacobi_fits(m, n, dtype) is fits
    assert JS.jacobi_fits(n, m, dtype) is fits


@pytest.mark.parametrize("elem, dtype", [(4, torch.float32),
                                         (8, torch.float64)])
@pytest.mark.parametrize("n", [1, 2, 7, 20])
def test_jacobi_fits_tall_edge(elem, dtype, n):
    """The tallest m x n matrix that fits is the last within the budget."""
    m = n
    while JS.smem_bytes(elem, m + 1, n) <= JS.SMEM_BUDGET:
        m += 1
    assert JS.jacobi_fits(m, n, dtype)
    assert not JS.jacobi_fits(m + 1, n, dtype)
    assert JS.smem_bytes(elem, m, n) <= JS.SMEM_BUDGET < JS.smem_bytes(
        elem, m + 1, n)


def test_svd_on_the_cpu_is_torch_linalg_svd():
    A = torch.from_numpy(matrices("cond_1e6", (3, 64, 32), 0.0))
    before = profiling.counters()
    for got, want in zip(tu._svd(A), torch.linalg.svd(A, full_matrices=False)):
        assert torch.equal(got, want)
    assert profiling.counters() == before


def _container(shape, lranks, rranks, dtype, seed):
    """A sketch container of random Ψ and Ω (the recovery reads nothing
    else)."""
    g = torch.Generator().manual_seed(seed)
    d = len(shape)
    lr, rr = (1,) + tuple(lranks), tuple(rranks) + (1,)
    psis = [torch.randn((lr[mu], shape[mu], rr[mu]), generator=g,
                        dtype=dtype) for mu in range(d)]
    omegas = [torch.randn((lranks[mu], rranks[mu]), generator=g, dtype=dtype)
              for mu in range(d - 1)]
    return SketchContainer(psis, omegas)


@pytest.mark.parametrize("ranks", [((4, 5, 3), (6, 8, 4)),
                                   ((5, 5, 5), (9, 9, 9))],
                         ids=["shapes_differ", "one_stack"])
@pytest.mark.parametrize("direction", ["right", "left"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_recovery_bits_equal_the_per_mode_path(direction, dtype, ranks):
    sk = _container((6, 7, 8, 5), *ranks, dtype, seed=2)
    cores = assemble_sketched_tt(sk, direction)
    if direction == "right":
        want = [tu.right_mul_pinv(P.reshape(-1, P.shape[2]), O).reshape(
                    P.shape[0], P.shape[1], O.shape[0])
                for P, O in zip(sk.Psi_cores[:-1], sk.Omega_mats)]
        want.append(sk.Psi_cores[-1])
    else:
        want = [sk.Psi_cores[0]] + [
            tu.left_mul_pinv(O, P.reshape(P.shape[0], -1)).reshape(
                O.shape[1], P.shape[1], P.shape[2])
            for P, O in zip(sk.Psi_cores[1:], sk.Omega_mats)]
    assert len(cores) == len(want)
    for got, ref in zip(cores, want):
        assert torch.equal(got, ref)


def test_lstsq_each_on_the_cpu_is_lstsq_per_system():
    A = torch.from_numpy(matrices("rank_noise", (3, 40, 20), 1e-16))
    B = [torch.from_numpy(rhs(A[i:i + 1].numpy(), k=i + 2))[0]
         for i in range(3)]
    got = tu.lstsq_each(list(zip(A, B)))
    for i in range(3):
        assert torch.equal(got[i], tu._lstsq(A[i], B[i]))


def test_lstsq_each_factors_each_shape_once_off_the_cpu():
    systems = [(torch.empty((40, 20), device="meta"),
                torch.empty((40, k), device="meta")) for k in (1, 6, 11)]
    systems.append((torch.empty((30, 20), device="meta"),
                    torch.empty((30, 4), device="meta")))
    before = profiling.counters().get("fallbacks.lstsq_svd", 0)
    out = tu.lstsq_each(systems)
    assert [tuple(x.shape) for x in out] == [(20, 1), (20, 6), (20, 11),
                                             (20, 4)]
    assert profiling.counters()["fallbacks.lstsq_svd"] - before == 2
