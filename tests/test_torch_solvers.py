"""TT-SVD, MPOs, the preconditioner, ``round_tt_sum`` and sketched TT-GMRES
of ``tt_sketch_torch`` against ``tt_sketch_tpu`` on the CPU.

Problems come from seeds in both packages: random TTs and MPOs from the
same host PCG64 streams (bit-identical), the cookie problem from the same
numpy draws.  Tolerances, with their reasons:

- cookie matrices, MPO draws and MPO cores carried across: exact (the
  same draws and rounding); ``MPO.random``'s cores within 1e-15 relative
  (each core is scaled by its norm, which XLA and torch sum in other
  orders: the scale factors differ in the last bit);
- MPO applications, preconditioner solves and TT-SVDs: 1e-12 relative to
  the largest value (float64 products, QRs and SVDs in another library);
- ``round_tt_sum``: 1e-10 relative (SVD sweeps, or a sketch with the same
  TT-DRMs recovered through pseudo-inverses);
- GMRES residual histories: rtol 1e-8 (measured about 1e-10: each
  iteration rounds through SVDs or a sketch whose rounding errors the
  Arnoldi recurrence carries on), solutions 1e-8 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_sketch_tpu.solvers as J
from tt_sketch_torch import config
from tt_sketch_torch import solvers as P
from tt_sketch_torch.formats import DenseTensor, TensorSum, TensorTrain
from tt_sketch_torch.interop import from_numpy_cores, mpo_from_numpy
from tt_sketch_torch.solvers import tt_gmres
from tt_sketch_torch.utils import hilbert_tensor
from tt_sketch_tpu.formats import DenseTensor as JDense
from tt_sketch_tpu.formats import TensorSum as JSum
from tt_sketch_tpu.formats import TensorTrain as JTrain
from tt_sketch_tpu.solvers import tt_gmres as jg
from tt_sketch_tpu.utils import hilbert_tensor as j_hilbert

HIST_RTOL = 1e-8
SOL_TOL = 1e-8


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _close(ours, ref, rel=1e-12):
    b = np.asarray(ref)
    a = ours.cpu().numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


def _rel(ours_tt, ref_tt):
    a = ours_tt.to_dense().numpy()
    b = np.asarray(ref_tt.to_dense())
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# -- TT-SVD ------------------------------------------------------------------

def test_tt_svd_exact_matches_jax():
    tt = TensorTrain.random((4, 5, 6), rank=3, seed=0)
    jt = JTrain.random((4, 5, 6), rank=3, seed=0)
    for given in (DenseTensor(tt.to_dense()), tt.to_dense(), tt):
        out = P.tt_svd(given, rank=3)
        assert out.rank == (3, 3)
        assert out.error(DenseTensor(tt.to_dense()), relative=True) < 1e-10
    ref = J.tt_svd(JDense(jt.to_dense()), rank=3)
    _close(out.to_dense(), ref.to_dense())


@pytest.mark.parametrize("rank, bound", [(5, 1e-4), (8, 1e-12), (None, 1e-12),
                                         ((2, 6, 3, 2), 2e-2)])
def test_tt_svd_hilbert_matches_jax(rank, bound):
    X = DenseTensor(hilbert_tensor(5, 4))
    JX = JDense(j_hilbert(5, 4))
    ours, ref = P.tt_svd(X, rank=rank), J.tt_svd(JX, rank=rank)
    assert ours.rank == ref.rank
    err = ours.error(X, relative=True)
    assert err < bound
    np.testing.assert_allclose(err, ref.error(JX, relative=True),
                               rtol=1e-6, atol=1e-14)
    _close(ours.to_dense(), ref.to_dense())


def test_tt_svd_takes_tensors_only():
    with pytest.raises(TypeError, match="Tensor"):
        P.tt_svd(np.ones((2, 3)))


# -- MPO and the preconditioner ---------------------------------------------

@pytest.mark.parametrize("rank, in_shape, out_shape, seed",
                         [(2, (3, 4, 5), (3, 4, 5), 0),
                          (3, (2, 3, 4), (4, 2, 3), 5),
                          ((1, 4), (3, 3, 2), (2, 3, 3), None)])
def test_mpo_random_matches_jax(rank, in_shape, out_shape, seed):
    if seed is None:
        seed = 11
    ours = P.MPO.random(rank, in_shape, out_shape, seed=seed)
    ref = J.MPO.random(rank, in_shape, out_shape, seed=seed)
    assert ours.rank == ref.rank and ours.shape == ref.shape
    assert ours.in_shape == in_shape and ours.out_shape == out_shape
    assert ours.size == ref.size
    for a, b in zip(ours.cores, ref.cores):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15,
                                   atol=0)
    carried = mpo_from_numpy([np.asarray(c) for c in ref.cores])
    assert carried.rank == ref.rank and carried.shape == ref.shape
    for a, b in zip(carried.cores, ref.cores):
        assert a.dtype == torch.float64 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mpo_vs_dense_and_jax():
    """MPO application equals the dense matrix-vector product, and the JAX
    package's application (``tests/test_solvers.py::test_mpo_vs_dense``)."""
    in_shape = out_shape = (3, 4, 5)
    ref = J.MPO.random(2, in_shape, out_shape, seed=0)
    mpo = mpo_from_numpy([np.asarray(c) for c in ref.cores])
    x = TensorTrain.random(in_shape, rank=2, seed=1)
    jx = JTrain.random(in_shape, rank=2, seed=1)
    y = mpo(x)
    assert y.rank == (4, 4)
    dense_op = mpo.to_dense().numpy()
    _close(mpo.to_dense(), ref.to_dense())
    expected = np.einsum("aibjck,abc->ijk", dense_op, x.to_dense().numpy())
    np.testing.assert_allclose(y.to_dense().numpy(), expected, atol=1e-10)
    _close(y.to_dense(), ref(jx).to_dense())
    _close(mpo.T(x).to_dense(), ref.T(jx).to_dense())
    _close(mpo.T.to_dense(), ref.T.to_dense())
    _close(mpo.to_tt().to_dense(), ref.to_tt().to_dense())
    _close((mpo * 0.5)(x).to_dense(), (ref * 0.5)(jx).to_dense())


def test_mpo_transpose_swaps_the_legs():
    mpo = P.MPO.random(2, (2, 3), (4, 5), seed=3)
    D, DT = mpo.to_dense().numpy(), mpo.T.to_dense().numpy()
    np.testing.assert_array_equal(DT, D.transpose(1, 0, 3, 2))
    assert mpo.T.in_shape == (4, 5) and mpo.T.out_shape == (2, 3)


def test_mpo_eye():
    shape = (3, 4, 2)
    x = TensorTrain.random(shape, rank=2, seed=0)
    eye = P.MPO.eye(shape)
    assert eye.dtype == torch.float64 and eye.device == torch.device("cpu")
    np.testing.assert_allclose(eye(x).to_dense().numpy(),
                               x.to_dense().numpy(), atol=1e-12)
    _close(eye.to_dense(), J.MPO.eye(shape).to_dense())
    assert P.MPO.eye(shape, dtype=torch.float32).dtype == torch.float32


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_precond_forward_backward(mode):
    shape = (6, 5, 4)
    A = np.random.default_rng(2).standard_normal((shape[mode],) * 2)
    A += shape[mode] * np.eye(shape[mode])
    pre, jpre = P.TTPrecond(A, shape, mode=mode), J.TTPrecond(A, shape,
                                                              mode=mode)
    x = TensorTrain.random(shape, rank=3, seed=4)
    jx = JTrain.random(shape, rank=3, seed=4)
    back, fwd = pre(x), pre.forward_call(x)
    _close(back.to_dense(), jpre(jx).to_dense())
    _close(fwd.to_dense(), jpre.forward_call(jx).to_dense())
    _close(pre.forward_call(back).to_dense(), x.to_dense().numpy())
    _close(pre.backward_call(fwd).to_dense(), x.to_dense().numpy())
    dense = np.moveaxis(np.tensordot(A, x.to_dense().numpy(),
                                     axes=(1, mode)), 0, mode)
    _close(fwd.to_dense(), dense)


def test_map_sum_checks_shapes():
    with pytest.raises(ValueError, match="empty"):
        P.TTLinearMapSum([])
    with pytest.raises(ValueError, match="in_shape"):
        P.TTLinearMapSum([P.MPO.eye((2, 3)), P.MPO.eye((3, 2))])
    maps = P.TTLinearMapSum([P.MPO.eye((2, 3)), P.MPO.eye((2, 3)) * 2.0])
    x = TensorTrain.random((2, 3), 2, seed=0)
    out = maps(x + x)
    assert isinstance(out, TensorSum) and out.num_summands == 4
    _close(out.to_dense(), 6 * x.to_dense().numpy())


# -- round_tt_sum -------------------------------------------------------------

def _sum_pair(shape=(4, 5, 6), terms=4):
    ours = [TensorTrain.random(shape, 2, seed=i) * (0.3 ** i)
            for i in range(terms)]
    ref = [JTrain.random(shape, 2, seed=i) * (0.3 ** i) for i in range(terms)]
    return TensorSum(ours), JSum(ref)


@pytest.mark.parametrize("method, eps",
                         [("exact", None), ("pairwise", None),
                          ("sketch", None), ("orth_sketch", None),
                          ("exact", 1e-3), ("pairwise", 1e-3)])
def test_round_tt_sum_matches_jax(method, eps):
    """The five modes (``None`` below) against the JAX package; the sketch
    modes draw the same TT-DRMs from the same seed, so the recovered
    tensors agree."""
    total, jtotal = _sum_pair()
    ours = P.round_tt_sum(total, max_rank=8, eps=eps, method=method, seed=7)
    ref = J.round_tt_sum(jtotal, max_rank=8, eps=eps, method=method, seed=7)
    assert ours.rank == ref.rank and all(r <= 8 for r in ours.rank)
    assert ours.dtype == torch.float64 and ours.device == total.device
    assert _rel(ours, ref) < 1e-10
    err = ours.error(DenseTensor(total.to_dense()), relative=True)
    assert err < (1e-6 if eps is None else 1e-2)


def test_round_tt_sum_none_and_single_tt():
    total, _ = _sum_pair()
    assert P.round_tt_sum(total, 8, method=None) is total
    tt = total.tensors[0]
    out = P.round_tt_sum(tt, 8, method="pairwise")
    assert out is tt
    with pytest.raises(ValueError, match="Unknown rounding"):
        P.round_tt_sum(total, 8, method="svd")


def test_sketch_rounding_follows_the_summands_dtype():
    total, _ = _sum_pair()
    f32 = TensorSum([TensorTrain([c.float() for c in t.cores])
                     for t in total.tensors])
    for method in ("sketch", "orth_sketch"):
        out = P.round_tt_sum(f32, 6, method=method, seed=1)
        assert out.dtype == torch.float32


def test_stacked_dots_match_one_dot_per_nu():
    shape = (4, 5, 3, 2)
    w = TensorTrain.random(shape, 3, seed=0)
    same = [TensorTrain.random(shape, 4, seed=s) for s in range(1, 6)]
    mixed = same[:2] + [TensorTrain.random(shape, 2, seed=9)]
    jw = JTrain.random(shape, 3, seed=0)
    jsame = [JTrain.random(shape, 4, seed=s) for s in range(1, 6)]
    for nus, jnus in ((same, jsame), (mixed, None), (same[:1], jsame[:1])):
        dots = tt_gmres._stacked_tt_dots(w, nus)
        assert dots.shape == (len(nus),) and dots.dtype == torch.float64
        one = np.array([float(w.dot_device(nu)) for nu in nus])
        np.testing.assert_allclose(dots.numpy(), one, rtol=1e-13,
                                   atol=1e-15)
        if jnus is not None:
            np.testing.assert_allclose(
                dots.numpy(), np.asarray(jg._stacked_tt_dots(jw, jnus)),
                rtol=1e-12, atol=1e-15)


# -- the cookie problem and GMRES ------------------------------------------

def test_cookie_problem_matches_jax():
    A, b, pre = P.prepare_synthetic_cookie_problem(num_coeffs=4,
                                                   num_cookies=2, n=20,
                                                   seed=0)
    jA, jb, jpre = J.prepare_synthetic_cookie_problem(num_coeffs=4,
                                                      num_cookies=2, n=20,
                                                      seed=0)
    assert A.in_shape == A.out_shape == jA.in_shape == (20, 4, 4)
    for m, jm in zip(A.linear_maps, jA.linear_maps):
        np.testing.assert_array_equal(m.A.numpy(), np.asarray(jm.A))
        np.testing.assert_array_equal(m.coeffs.numpy(), np.asarray(jm.coeffs))
        assert m.mode == jm.mode
    np.testing.assert_array_equal(pre.A.numpy(), np.asarray(jpre.A))
    np.testing.assert_array_equal(b.to_dense().numpy(),
                                  np.asarray(jb.to_dense()))
    x = TensorTrain.random(A.in_shape, 2, seed=3)
    jx = JTrain.random(A.in_shape, 2, seed=3)
    _close(A(x).to_dense(), jA(jx).to_dense())
    # the loader takes outside matrices too
    A2, b2, _ = P.prepare_cookie_problem(
        [np.asarray(jm.A) for jm in jA.linear_maps], np.ones(20), 4)
    _close(A2(x).to_dense(), jA(jx).to_dense())


def _cookie_kw(rounding):
    return dict(max_rank=10, tolerance=1e-6, maxiter=20,
                rounding_method=rounding, seed=123,
                save_basis=rounding == "sketch")


@pytest.mark.parametrize("rounding", ["pairwise", "sketch"])
def test_gmres_cookie_matches_jax(rounding):
    """``tests/test_solvers.py::test_gmres_cookie`` in both packages: the
    same residual history, ranks and solution (with sketch rounding also
    the saved Hessenberg matrix, basis, ``y`` and unrounded solution sum);
    the port's true residual of the preconditioned system under the same
    bound."""
    A, b, pre = P.prepare_synthetic_cookie_problem(num_coeffs=4,
                                                   num_cookies=2, n=20,
                                                   seed=0)
    x, hist = P.tt_sum_gmres(A, b, precond=pre, **_cookie_kw(rounding))
    jA, jb, jpre = J.prepare_synthetic_cookie_problem(num_coeffs=4,
                                                      num_cookies=2, n=20,
                                                      seed=0)
    jx, jhist = J.tt_sum_gmres(jA, jb, precond=jpre, **_cookie_kw(rounding))
    res, jres = np.asarray(hist["residual_norm"]), np.asarray(
        jhist["residual_norm"])
    assert res.shape == jres.shape == (21,)
    np.testing.assert_allclose(res, jres, rtol=HIST_RTOL, atol=0)
    np.testing.assert_allclose(hist["w_norm"], jhist["w_norm"],
                               rtol=HIST_RTOL)
    np.testing.assert_allclose(hist["delta"], jhist["delta"], rtol=HIST_RTOL)
    assert hist["rank"] == [tuple(r) for r in jhist["rank"]]
    assert hist["converged"] == jhist["converged"]
    assert hist["breakdown"] == jhist["breakdown"]
    assert sorted(hist) == sorted(jhist)
    assert x.rank == jx.rank
    assert _rel(x, jx) < SOL_TOL
    if rounding == "sketch":
        H, jH = hist["H_matrix"], jhist["H_matrix"]
        np.testing.assert_allclose(H, jH, rtol=0,
                                   atol=HIST_RTOL * np.abs(jH).max())
        np.testing.assert_allclose(hist["y"], jhist["y"], rtol=HIST_RTOL)
        assert len(hist["nu_list"]) == len(jhist["nu_list"]) == len(
            hist["y"])
        for nu, jnu in zip(hist["nu_list"], jhist["nu_list"]):
            assert _rel(nu, jnu) < SOL_TOL
        assert isinstance(hist["solution_sum"], TensorSum)
        _close(hist["solution_sum"].to_dense(),
               jhist["solution_sum"].to_dense(), rel=SOL_TOL)
    assert res[-1] < 2e-2 and res[-1] < res[0] / 20
    b_pr = pre(b)
    Ax_pr = TensorSum([pre(t) for t in A(x).tensors])
    true_res = (float(torch.linalg.norm((b_pr + Ax_pr * (-1.0)).to_dense()))
                / float(torch.linalg.norm(b_pr.to_dense())))
    assert true_res < (0.3 if rounding == "pairwise" else 0.6)


def test_gmres_identity():
    """GMRES on the identity solves in one iteration."""
    shape = (3, 4, 3)
    A = P.TTLinearMapSum([P.MPO.eye(shape)])
    b = TensorTrain.random(shape, rank=2, seed=0)
    x, history = P.tt_sum_gmres(
        A, b, max_rank=6, tolerance=1e-10, maxiter=5, rounding_method="exact"
    )
    assert x.error(b, relative=True) < 1e-8
    assert history["converged"]


def test_gmres_breakdown_honest():
    """Arnoldi breakdown is not reported as convergence
    (``tests/test_solvers.py::test_gmres_breakdown_honest``)."""
    shape = (3, 4, 3)
    A = P.TTLinearMapSum([P.MPO.eye(shape) * 0.0])
    b = TensorTrain.random(shape, rank=2, seed=0)
    for dr in (False, True):
        x, history = P.tt_sum_gmres(
            A, b, max_rank=6, tolerance=1e-10, maxiter=5,
            rounding_method="exact", device_resident=dr,
        )
        assert history["breakdown"]
        assert not history["converged"]
        assert history["residual_norm"][-1] > 0.9  # nothing solved
        assert len(history["delta"]) == 1  # stopped after the breakdown


def test_gmres_zero_rhs_returns_x0():
    shape = (3, 4, 3)
    A = P.TTLinearMapSum([P.MPO.eye(shape)])
    b = TensorTrain.zero(shape, 2)
    x, history = P.tt_sum_gmres(A, b, max_rank=4, rounding_method="exact")
    assert history["converged"] and history["residual_norm"] == [0.0]
    assert x.rank == (1, 1) and x.dtype == b.dtype and x.device == b.device


def test_gmres_checks_shapes():
    A = P.TTLinearMapSum([P.MPO.eye((3, 4))])
    with pytest.raises(ValueError, match="RHS"):
        P.tt_sum_gmres(A, TensorTrain.random((4, 3), 1, seed=0), 2)
    with pytest.raises(ValueError, match="x0"):
        P.tt_sum_gmres(A, TensorTrain.random((3, 4), 1, seed=0), 2,
                       x0=TensorTrain.random((4, 3), 1, seed=0))
    B = P.TTLinearMapSum([P.MPO.random(1, (3, 4), (4, 3), seed=0)])
    with pytest.raises(ValueError, match="automorphisms"):
        P.tt_sum_gmres(B, TensorTrain.random((4, 3), 1, seed=0), 2)


@pytest.mark.parametrize("rounding", ["pairwise", "sketch"])
def test_gmres_device_resident_parity(rounding):
    """``device_resident=True`` (masked rounding) follows the trajectory of
    the eager route (``tests/test_solvers.py::
    test_gmres_device_resident_parity``)."""
    A, b, precond = P.prepare_synthetic_cookie_problem(
        num_coeffs=3, num_cookies=2, n=12, seed=0
    )
    kw = dict(max_rank=8, precond=precond, tolerance=1e-6, maxiter=8,
              rounding_method=rounding, seed=123)
    x_host, h_host = P.tt_sum_gmres(A, b, device_resident=False, **kw)
    x_dev, h_dev = P.tt_sum_gmres(A, b, device_resident=True, **kw)
    np.testing.assert_allclose(np.asarray(h_dev["residual_norm"]),
                               np.asarray(h_host["residual_norm"]),
                               rtol=1e-8, atol=1e-12)
    assert x_dev.error(x_host, relative=True) < 1e-8
    # entry 0 differs by design: the initial residual is rounded with
    # eps=None (static rank on the host route, effective rank masked)
    assert h_dev["rank"][1:] == [tuple(r) for r in h_host["rank"][1:]]


def test_device_resident_auto_is_false_on_the_cpu(monkeypatch):
    """``"auto"`` means "b's cores lie on CUDA": on the CPU the eager
    route runs and the masked one is never called (the JAX package's
    ``is_tpu()``; ROADMAP Queue 3)."""
    def fail(*a, **k):
        raise AssertionError("the device-resident route ran")

    A, b, pre = P.prepare_synthetic_cookie_problem(num_coeffs=3,
                                                   num_cookies=2, n=12)
    kw = dict(max_rank=8, precond=pre, maxiter=3, rounding_method="pairwise",
              seed=1)
    _, h_false = P.tt_sum_gmres(A, b, device_resident=False, **kw)
    monkeypatch.setattr(tt_gmres, "_round_tt_sum_static", fail)
    _, h_auto = P.tt_sum_gmres(A, b, **kw)
    assert h_auto["residual_norm"] == h_false["residual_norm"]
    with pytest.raises(AssertionError, match="device-resident"):
        P.tt_sum_gmres(A, b, device_resident=True, **kw)


def test_gmres_keeps_an_f32_problem_f32():
    A, b, pre = P.prepare_synthetic_cookie_problem(num_coeffs=3,
                                                   num_cookies=2, n=12)
    b32 = TensorTrain([c.float() for c in b.cores])
    for m in A.linear_maps:
        m.A, m.coeffs = m.A.float(), m.coeffs.float()
    x, hist = P.tt_sum_gmres(A, b32, max_rank=6, maxiter=3,
                             rounding_method="sketch", seed=3,
                             save_basis=True)
    assert x.dtype == torch.float32
    assert all(nu.dtype == torch.float32 for nu in hist["nu_list"])


# -- no card ------------------------------------------------------------------

def test_no_card_means_an_error_for_the_new_entry_points(monkeypatch):
    """With no card and no ``device=`` every new constructor raises; the
    functions of given tensors run where those lie."""
    from tt_sketch_torch import utils as tu

    A = np.eye(3) * 2.0
    tt = TensorTrain.random((3, 4), 2, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.set_default_device("cuda")
    for make in (lambda: tu.hilbert_tensor(3, 4),
                 lambda: tu.sqrt_tensor((3, 4)),
                 lambda: tu.power_decay_tensor((3, 4), seed=0),
                 lambda: P.MPO.random(2, (3, 4), (3, 4), seed=0),
                 lambda: P.MPO.eye((3, 4)),
                 lambda: P.TTPrecond(A, (3, 4)),
                 lambda: P.CookieMap(A, 1, (3, 4), np.ones(4)),
                 lambda: P.prepare_synthetic_cookie_problem(3, 2, 12),
                 lambda: P.prepare_cookie_problem([A, A], np.ones(3), 4),
                 lambda: mpo_from_numpy([np.ones((1, 2, 2, 1))]),
                 lambda: from_numpy_cores([A])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert tu.hilbert_tensor(3, 4, device="cpu").device.type == "cpu"
    assert P.tt_svd(tt.to_dense(), 2).device.type == "cpu"
    for method in ("pairwise", "sketch"):
        assert P.round_tt_sum(tt + tt, 2, method=method,
                              seed=0).device.type == "cpu"
    maps = P.TTLinearMapSum([P.MPO.eye((3, 4), device="cpu")])
    x, _ = P.tt_sum_gmres(maps, tt, 2, maxiter=2, rounding_method="sketch",
                          seed=0)
    assert x.device.type == "cpu"
