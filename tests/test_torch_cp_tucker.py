"""CP and Tucker formats, their chain steps and sketches, and
``DenseGaussianDRM`` of the port, against the JAX package.

Everything here is float64 ``einsum``s, products and indexing (the JAX
package has no Pallas kernel on these paths).  Tolerances, with their
reasons:

- random factors, DRM matrices and gathered values: bit for bit (the same
  host PCG64 streams and rounding) or 1e-12 (the same products summed in
  another order);
- contractions and streaming sketches: 1e-12 relative to the largest value;
- sequential sketches (a QR per mode, column signs the library's choice):
  recovered dense tensors, ``1e-10·max|ref|``;
- exact recovery (sketch rank at least the tensor's TT rank): 1e-8
  relative error, as ``tests/test_sketching.py::test_exact_recovery``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_sketch_tpu as jts
from tt_sketch_torch import config
from tt_sketch_torch.drm import (
    DenseGaussianDRM,
    SparseGaussianDRM,
    SparseSignDRM,
    TensorTrainDRM,
)
from tt_sketch_torch.drm.tensor_train_drm import (
    chain_step_cp,
    chain_step_tucker,
)
from tt_sketch_torch.engine.sketch import (
    hmt_sketch,
    orthogonal_sketch,
    stream_sketch,
)
from tt_sketch_torch.formats import (
    CPTensor,
    DenseTensor,
    SparseTensor,
    TensorTrain,
    TuckerTensor,
)
from tt_sketch_torch.interop import (
    cp_tensor_from_numpy,
    tucker_tensor_from_numpy,
)
from tt_sketch_torch.kernels import sketch_kernels as K
from tt_sketch_tpu.drm import DenseGaussianDRM as JDG
from tt_sketch_tpu.drm import SparseGaussianDRM as JSG
from tt_sketch_tpu.drm import SparseSignDRM as JSS
from tt_sketch_tpu.drm import TensorTrainDRM as JTT
from tt_sketch_tpu.drm.tensor_train_drm import chain_step_cp as j_step_cp
from tt_sketch_tpu.drm.tensor_train_drm import (
    chain_step_tucker as j_step_tucker,
)
from tt_sketch_tpu.formats import CPTensor as JCP
from tt_sketch_tpu.formats import DenseTensor as JDense
from tt_sketch_tpu.formats import SparseTensor as JST
from tt_sketch_tpu.formats import TensorTrain as JTrain
from tt_sketch_tpu.formats import TuckerTensor as JTucker
from tt_sketch_tpu.kernels import sketch_kernels as JK

SHAPE = (5, 6, 7, 4)
ALL = {"tt": (TensorTrainDRM, JTT), "dense": (DenseGaussianDRM, JDG),
       "gauss": (SparseGaussianDRM, JSG), "sign": (SparseSignDRM, JSS)}


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _close(ours, ref, rel=1e-12):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=rel * max(np.abs(b).max(), 1e-300))


def _tucker_pair(shape=SHAPE, rank=(2, 3, 2, 3), seed=3):
    """The JAX package's Tucker tensor and the port's with the same
    factors (carried across: the QR's signs are LAPACK's choice)."""
    jt = JTucker.random(shape, rank, seed=seed)
    return tucker_tensor_from_numpy([np.asarray(U) for U in jt.factors],
                                    np.asarray(jt.core)), jt


# -- CP ------------------------------------------------------------------------

def test_cp_random_is_bit_identical():
    cp, jcp = CPTensor.random(SHAPE, 3, seed=2), JCP.random(SHAPE, 3, seed=2)
    assert cp.rank == jcp.rank == 3 and cp.shape == jcp.shape == SHAPE
    for a, b in zip(cp.cores, jcp.cores):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    f32 = CPTensor.random(SHAPE, 3, seed=2, dtype=torch.float32)
    jf32 = JCP.random(SHAPE, 3, seed=2, dtype=jnp.float32)
    assert f32.dtype == torch.float32 and f32.device == torch.device("cpu")
    for a, b in zip(f32.cores, jf32.cores):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cp_format_matches_jax():
    """``to_dense``, ``to_tt`` (exact), ``gather``, ``size`` (a property,
    as in the JAX package), ``T``, ``[]``, ``*`` and ``repr``."""
    cp, jcp = CPTensor.random(SHAPE, 3, seed=2), JCP.random(SHAPE, 3, seed=2)
    dense = np.asarray(jcp.to_dense())
    np.testing.assert_allclose(cp.to_dense().numpy(), dense, atol=1e-12)
    tt, jtt = cp.to_tt(), jcp.to_tt()
    assert tt.rank == jtt.rank
    for a, b in zip(tt.cores, jtt.cores):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tt.to_dense().numpy(), dense, atol=1e-12)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, s, 50) for s in SHAPE])
    np.testing.assert_allclose(cp.gather(idx).numpy(),
                               np.asarray(jcp.gather(idx)), atol=1e-12)
    np.testing.assert_allclose(cp.gather(torch.from_numpy(idx)).numpy(),
                               dense[tuple(idx)], atol=1e-12)
    assert cp.size == jcp.size == sum(n * 3 for n in SHAPE)
    np.testing.assert_allclose(cp.T.to_dense().numpy(),
                               np.asarray(jcp.T.to_dense()), atol=1e-12)
    np.testing.assert_array_equal(cp[1].numpy(), np.asarray(jcp[1]))
    np.testing.assert_allclose((cp * -2.0).to_dense().numpy(),
                               np.asarray((jcp * -2.0).to_dense()),
                               atol=1e-12)
    assert repr(cp) == repr(jcp)
    assert cp.norm() == pytest.approx(jcp.norm(), abs=1e-12)


def test_cp_problem_carried_across():
    """``cp_problem`` of the experiments (component norms 1/k^5) through
    ``interop``, sketched by both packages."""
    from tt_sketch_tpu.experiments.problems import cp_problem

    jcp = cp_problem(n_dims=4, dim=6, cp_rank=12, seed=179)
    cp = cp_tensor_from_numpy([np.asarray(c) for c in jcp.cores])
    ours = stream_sketch(cp, 6, 9, seed=4)
    ref = jts.stream_sketch(jcp, 6, 9, seed=4)
    _close(ours.Psi_cores + ours.Omega_mats, ref.Psi_cores + ref.Omega_mats)


# -- Tucker --------------------------------------------------------------------

def test_tucker_format_matches_jax():
    tk, jt = _tucker_pair()
    assert tk.shape == jt.shape == SHAPE and tk.rank == jt.rank
    np.testing.assert_allclose(tk.to_dense().numpy(),
                               np.asarray(jt.to_dense()), atol=1e-12)
    np.testing.assert_allclose(tk.T.to_dense().numpy(),
                               np.asarray(jt.T.to_dense()), atol=1e-12)
    assert tk.T.shape == SHAPE[::-1] and tk.T.rank == jt.T.rank
    assert tk.size == jt.size
    np.testing.assert_allclose((tk * 3.0).to_dense().numpy(),
                               np.asarray((jt * 3.0).to_dense()), atol=1e-12)
    assert repr(tk) == repr(jt)
    assert tk.device == torch.device("cpu") and tk.dtype == torch.float64


@pytest.mark.parametrize("rank", [2, (2, 3, 9, 1)])
def test_tucker_random_matches_jax_up_to_qr_signs(rank):
    """``random``'s shapes (ranks clipped to the modes), orthonormal row
    factors, the core bit for bit, and the factors equal to the JAX
    package's to 1e-12 once each row's sign is matched (the QR's column
    signs are LAPACK's choice in each package)."""
    tk = TuckerTensor.random(SHAPE, rank, seed=8)
    jt = JTucker.random(SHAPE, rank, seed=8)
    assert tk.rank == jt.rank and tk.shape == jt.shape
    np.testing.assert_array_equal(tk.core.numpy(), np.asarray(jt.core))
    for U, JU in zip(tk.factors, jt.factors):
        U, JU = U.numpy(), np.asarray(JU)
        assert U.shape == JU.shape
        np.testing.assert_allclose(U @ U.T, np.eye(U.shape[0]), atol=1e-12)
        signs = np.sign(np.sum(U * JU, axis=1))
        np.testing.assert_allclose(U * signs[:, None], JU, atol=1e-12)


# -- chain steps and the TT-DRM's sketches --------------------------------------

def _cores(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def test_chain_steps_match_jax():
    """``chain_step_cp`` and ``chain_step_tucker``, first step and later."""
    core0, core1 = _cores([(1, 5, 3), (3, 6, 4)], 0)
    f0, f1 = _cores([(5, 7), (6, 7)], 1)
    s0 = chain_step_cp(None, torch.from_numpy(core0), torch.from_numpy(f0))
    j0 = j_step_cp(None, jnp.asarray(core0), jnp.asarray(f0))
    _close([s0], [j0])
    s1 = chain_step_cp(s0, torch.from_numpy(core1), torch.from_numpy(f1))
    _close([s1], [j_step_cp(j0, jnp.asarray(core1), jnp.asarray(f1))])
    u0, u1 = _cores([(2, 5), (3, 6)], 2)
    t0 = chain_step_tucker(None, torch.from_numpy(core0),
                           torch.from_numpy(u0))
    jt0 = j_step_tucker(None, jnp.asarray(core0), jnp.asarray(u0))
    _close([t0], [jt0])
    t1 = chain_step_tucker(t0, torch.from_numpy(core1), torch.from_numpy(u1))
    _close([t1], [j_step_tucker(jt0, jnp.asarray(core1), jnp.asarray(u1))])


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("sliced", [False, True])
def test_tt_drm_sketch_cp_and_tucker_match_jax(transpose, sliced):
    cp, jcp = CPTensor.random(SHAPE, 4, seed=1), JCP.random(SHAPE, 4, seed=1)
    tk, jt = _tucker_pair()
    d = TensorTrainDRM((3, 5, 4), SHAPE, transpose, seed=6)
    jd = JTT((3, 5, 4), SHAPE, transpose, seed=6)
    if sliced:
        d, jd = d.slice((1, 2, 0), (3, 4, 2)), jd.slice((1, 2, 0), (3, 4, 2))
    _close(d.sketch_cp(cp), jd.sketch_cp(jcp))
    _close(d.sketch_tucker(tk), jd.sketch_tucker(jt))


@pytest.mark.parametrize("fmt", ["cp", "tucker"])
def test_psi_omega_functions_match_jax(fmt):
    """``sketch_{psi,omega}_{cp,tucker}`` at every mode, from the same DRM
    contraction lists, both sides present or absent."""
    if fmt == "cp":
        t, jt = CPTensor.random(SHAPE, 4, seed=1), JCP.random(SHAPE, 4,
                                                              seed=1)
    else:
        t, jt = _tucker_pair()
    method = "sketch_" + fmt
    ld, rd = (TensorTrainDRM(3, SHAPE, False, seed=1),
              TensorTrainDRM(5, SHAPE, True, seed=2))
    jld, jrd = JTT(3, SHAPE, False, seed=1), JTT(5, SHAPE, True, seed=2)
    left, right = getattr(ld, method)(t), getattr(rd, method)(t)
    jleft, jright = getattr(jld, method)(jt), getattr(jrd, method)(jt)
    psi, jpsi = getattr(K, f"sketch_psi_{fmt}"), getattr(JK,
                                                         f"sketch_psi_{fmt}")
    om, jom = getattr(K, f"sketch_omega_{fmt}"), getattr(JK,
                                                         f"sketch_omega_{fmt}")
    d = len(SHAPE)
    for mu in range(d):
        lft = left[mu - 1] if mu > 0 else None
        rgt = right[mu] if mu < d - 1 else None
        jl = jleft[mu - 1] if mu > 0 else None
        jr = jright[mu] if mu < d - 1 else None
        shape = (3 if mu else 1, SHAPE[mu], 5 if mu < d - 1 else 1)
        _close([psi(lft, rgt, tensor=t, mu=mu)],
               [jpsi(jl, jr, tensor=jt, mu=mu, psi_shape=shape)])
        if mu < d - 1:
            _close([om(left[mu], right[mu], tensor=t, mu=mu)],
                   [jom(jleft[mu], jright[mu], tensor=jt, mu=mu,
                        omega_shape=(3, 5))])


# -- the three methods -----------------------------------------------------------

def _recover(method, t, lr, rr, drm, seed, lib):
    if method == "stream":
        return lib.stream_sketch(t, lr, rr, seed=seed, left_drm_type=drm,
                                 right_drm_type=drm)
    if method == "orth":
        return lib.orthogonal_sketch(t, lr, rr, seed=seed,
                                     left_drm_type=drm, right_drm_type=drm)
    return lib.hmt_sketch(t, rr, seed=seed, drm_type=drm)


class _Port:
    stream_sketch = staticmethod(stream_sketch)
    orthogonal_sketch = staticmethod(orthogonal_sketch)
    hmt_sketch = staticmethod(hmt_sketch)


def _inputs(fmt):
    if fmt == "cp":
        return CPTensor.random(SHAPE, 2, seed=0), JCP.random(SHAPE, 2, seed=0)
    if fmt == "tucker":
        return _tucker_pair(rank=2, seed=0)
    a, b, c = (TensorTrain.random(SHAPE, 1, seed=s) for s in range(3))
    ja, jb, jc = (JTrain.random(SHAPE, 1, seed=s) for s in range(3))
    return a + b + c, ja + jb + jc


@pytest.mark.parametrize("fmt", ["cp", "tucker", "sum"])
@pytest.mark.parametrize("method", ["stream", "orth", "hmt"])
def test_exact_recovery_matches_jax(fmt, method):
    """``tests/test_sketching.py::test_exact_recovery`` on CP, Tucker and a
    sum of TTs: every DRM that can sketch the format recovers it to 1e-8
    and gives the JAX package's tensor; every other one raises
    ``AttributeError`` in both packages."""
    t, jt = _inputs(fmt)
    capable = {"cp": ("tt",), "tucker": ("tt",), "sum": ("tt", "dense")}
    for name, (drm, jdrm) in ALL.items():
        if name not in capable[fmt]:
            for lib, x, dt in ((_Port, t, drm), (jts, jt, jdrm)):
                with pytest.raises(AttributeError):
                    _recover(method, x, (3, 4, 3), (4, 6, 4), dt, 17, lib)
            continue
        ours = _recover(method, t, (3, 4, 3), (4, 6, 4), drm, 17, _Port)
        ref = _recover(method, jt, (3, 4, 3), (4, 6, 4), jdrm, 17, jts)
        if method == "stream":
            _close(ours.Psi_cores + ours.Omega_mats,
                   ref.Psi_cores + ref.Omega_mats)
            ours, ref = ours.to_tt(), ref.to_tt()
        b = np.asarray(ref.to_dense())
        np.testing.assert_allclose(ours.to_dense().numpy(), b, rtol=0,
                                   atol=1e-10 * np.abs(b).max())
        assert ours.error(t, relative=True) < 1e-8, name


@pytest.mark.parametrize("fmt", ["cp", "tucker", "sum"])
def test_default_drm(fmt):
    """``tests/test_sketching.py::test_default_drm``: no DRM argument."""
    t, jt = _inputs(fmt)
    ours = stream_sketch(t, 5, 8, seed=2)
    ref = jts.stream_sketch(jt, 5, 8, seed=2)
    assert type(ours.left_drm).__name__ == type(ref.left_drm).__name__
    _close(ours.Psi_cores + ours.Omega_mats, ref.Psi_cores + ref.Omega_mats)
    assert ours.to_tt().error(t, relative=True) < 1e-8


def test_default_drm_table_matches_jax():
    from tt_sketch_torch.engine.sketch import DEFAULT_DRM
    from tt_sketch_tpu.engine.sketch import DEFAULT_DRM as J_DEFAULT

    assert ({k.__name__: v.__name__ for k, v in DEFAULT_DRM.items()}
            == {k.__name__: v.__name__ for k, v in J_DEFAULT.items()})


# -- DenseGaussianDRM --------------------------------------------------------------

@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rank", [4, (3, 5, 2)])
def test_dense_gaussian_matrices_bit_identical(transpose, dtype, rank):
    ours = DenseGaussianDRM(rank, SHAPE, transpose, seed=9,
                            dtype=getattr(torch, dtype))
    ref = JDG(rank, SHAPE, transpose, seed=9, dtype=getattr(jnp, dtype))
    assert ours.rank == ref.rank and ours.true_rank == ref.true_rank
    assert ours.device == torch.device("cpu")
    assert ours.dtype == getattr(torch, dtype)
    assert len(ours.sketching_mats) == len(ref.sketching_mats)
    for a, b in zip(ours.sketching_mats, ref.sketching_mats):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for start, end in (((1, 0, 1), (3, 4, 2)), ((0, 2, 0), (2, 3, 1))):
        s, js = ours.slice(start, end), ref.slice(start, end)
        assert s.rank == js.rank
        for a, b in zip(s.sketching_mats, js.sketching_mats):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    big, jbig = ours.increase_rank((6, 7, 5)), ref.increase_rank((6, 7, 5))
    for a, b, small in zip(big.sketching_mats, jbig.sketching_mats,
                           ours.sketching_mats):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # prefix stability: the old matrices are the leading rows
        np.testing.assert_array_equal(a[: small.shape[0]].numpy(),
                                      small.numpy())


@pytest.mark.parametrize("transpose", [False, True])
def test_dense_gaussian_sketch_methods_match_jax(transpose):
    """``sketch_sparse``, ``sketch_tt`` and ``sketch_dense``."""
    ours = DenseGaussianDRM((3, 5, 2), SHAPE, transpose, seed=4)
    ref = JDG((3, 5, 2), SHAPE, transpose, seed=4)
    sp, jsp = SparseTensor.random(SHAPE, 40, seed=1), JST.random(SHAPE, 40,
                                                                 seed=1)
    tt, jtt = TensorTrain.random(SHAPE, 3, seed=2), JTrain.random(SHAPE, 3,
                                                                  seed=2)
    dn, jdn = DenseTensor.random(SHAPE, seed=3), JDense.random(SHAPE, seed=3)
    _close(ours.sketch_sparse(sp), ref.sketch_sparse(jsp))
    _close(ours.sketch_tt(tt), ref.sketch_tt(jtt))
    _close(ours.sketch_dense(dn), ref.sketch_dense(jdn))
    for method in ("sketch_cp", "sketch_tucker"):
        assert not hasattr(ours, method) and not hasattr(ref, method)


@pytest.mark.parametrize("fmt", ["sparse", "tt", "dense", "tt+sparse"])
@pytest.mark.parametrize("method", ["stream", "orth", "hmt"])
def test_dense_gaussian_pair_matches_jax(fmt, method):
    """The three methods with a ``DenseGaussianDRM`` pair; the
    ``tt_plus_sparse_problem`` shape of the experiments among them."""
    if fmt == "sparse":
        t, jt = (SparseTensor.random(SHAPE, 60, seed=1),
                 JST.random(SHAPE, 60, seed=1))
    elif fmt == "tt":
        t, jt = (TensorTrain.random(SHAPE, 2, seed=2),
                 JTrain.random(SHAPE, 2, seed=2))
    elif fmt == "dense":
        t, jt = DenseTensor.random(SHAPE, seed=3), JDense.random(SHAPE,
                                                                 seed=3)
    else:
        from tt_sketch_tpu.experiments.problems import tt_plus_sparse_problem
        from tt_sketch_torch.interop import tensor_sum_from_numpy

        jt = tt_plus_sparse_problem(n_dims=4, dim=6, tt_rank=2, nnz=20)
        jsp, jtt = jt.tensors
        t = tensor_sum_from_numpy([
            ("sparse", jsp.shape, np.array(jsp.indices),
             np.array(jsp.entries)),
            ("tt", [np.asarray(c) for c in jtt.cores])])
    ours = _recover(method, t, 3, 5, DenseGaussianDRM, 21, _Port)
    ref = _recover(method, jt, 3, 5, JDG, 21, jts)
    if method == "stream":
        _close(ours.Psi_cores + ours.Omega_mats,
               ref.Psi_cores + ref.Omega_mats)
        ours, ref = ours.to_tt(), ref.to_tt()
    b = np.asarray(ref.to_dense())
    np.testing.assert_allclose(ours.to_dense().numpy(), b, rtol=0,
                               atol=1e-10 * np.abs(b).max())


def test_no_card_means_an_error_for_the_new_inputs(monkeypatch):
    """The entry points run on the card by default: with no card and no
    ``device=`` they raise for CP, Tucker and sum input and for a dense
    Gaussian DRM, as for the other formats
    (``tests/test_torch_sketch.py::test_no_card_means_an_error_not_the_cpu``),
    and run on the CPU when asked."""
    cp = CPTensor.random(SHAPE, 2, seed=0)
    tk, _ = _tucker_pair()
    total = cp + TensorTrain.random(SHAPE, 2, seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.set_default_device("cuda")
    for make in (lambda: CPTensor.random(SHAPE, 2, seed=0),
                 lambda: TuckerTensor.random(SHAPE, 2, seed=0),
                 lambda: DenseGaussianDRM(3, SHAPE, False, seed=0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    for t in (cp, tk, total):
        for run in (lambda: stream_sketch(t, 3, 5, seed=0),
                    lambda: orthogonal_sketch(t, 3, 5, seed=0),
                    lambda: hmt_sketch(t, 3, seed=0)):
            with pytest.raises(RuntimeError, match="CUDA"):
                run()
        tt = hmt_sketch(t, 3, seed=0, device="cpu")
        assert tt.device.type == "cpu"
