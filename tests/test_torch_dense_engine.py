"""The port's dense sketch engine against the JAX package's generic engine
(mirrors tests/test_dense_engine.py).

Tolerances: float64 Ψ/Ω against ``general_sketch`` to atol 1e-11 (sums
in another order); ``dual_project_reference`` against the Pallas kernel in
interpret mode to rtol 2e-5 / atol 2e-4 in float32, as the JAX test holds
the kernel against XLA.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_sketch_torch import config, profiling
from tt_sketch_torch.drm import TensorTrainDRM
from tt_sketch_torch.engine.sketch import SketchedTensorTrain
from tt_sketch_torch.engine.sketch_container import SketchContainer
from tt_sketch_torch.formats import DenseTensor, TensorTrain
from tt_sketch_torch.kernels import dual_project as dp
from tt_sketch_torch.kernels.dense_engine import (
    dense_stream_sketch_bisect,
    dense_stream_sketch_container,
    dense_stream_sketch_fused,
    slab_stream_sketch,
)
from tt_sketch_tpu.drm import TensorTrainDRM as JDRM
from tt_sketch_tpu.engine.dispatch import SketchMethod as JMethod
from tt_sketch_tpu.engine.dispatch import general_sketch as j_general_sketch
from tt_sketch_tpu.formats import DenseTensor as JDense
from tt_sketch_tpu.formats import TensorTrain as JTT

SHAPE = (8, 5, 6, 7)


def _launches(wrapper):
    """The launches counted for kernel wrapper ``wrapper`` so far."""
    return profiling.counters().get(f"launches.{wrapper}", 0)


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _setup(shape=SHAPE, lrank=(4, 4, 4), rrank=(7, 7, 7), tt_rank=3, seed=0):
    tt = TensorTrain.random(shape, tt_rank, seed=seed)
    X = DenseTensor(tt.to_dense())
    ld = TensorTrainDRM(lrank, shape=shape, transpose=False, seed=1)
    rd = TensorTrainDRM(rrank, shape=shape, transpose=True, seed=2)
    jX = JDense(JTT.random(shape, tt_rank, seed=seed).to_dense())
    jld = JDRM(lrank, shape=shape, transpose=False, seed=1)
    jrd = JDRM(rrank, shape=shape, transpose=True, seed=2)
    ref = j_general_sketch(jX, jld, jrd, JMethod.streaming)
    return X, ld, rd, ref


def _assert_sketch_close(psis, omegas, ref, atol):
    assert len(psis) == len(ref.Psi_cores)
    assert len(omegas) == len(ref.Omega_mats)
    for a, b in zip(psis, ref.Psi_cores):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)
    for a, b in zip(omegas, ref.Omega_mats):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


def test_fused_equals_jax_generic():
    X, ld, rd, ref = _setup()
    psis, omegas = dense_stream_sketch_fused(X.data, ld.cores, rd.cores)
    _assert_sketch_close(psis, omegas, ref, atol=1e-11)
    cont = dense_stream_sketch_container(X.data, ld.cores, rd.cores)
    _assert_sketch_close(cont.Psi_cores, cont.Omega_mats, ref, atol=1e-11)


@pytest.mark.parametrize("pivot", [0, 1, 2, None])
@pytest.mark.parametrize("projector", ["matmul", "auto", "kernel"])
def test_bisect_equals_jax_generic_all_pivots(pivot, projector):
    X, ld, rd, ref = _setup()
    psis, omegas = dense_stream_sketch_bisect(
        X.data, ld.cores, rd.cores, pivot=pivot, projector=projector
    )
    _assert_sketch_close(psis, omegas, ref, atol=1e-11)


def test_bisect_two_modes():
    X, ld, rd, ref = _setup(shape=(9, 11), lrank=(3,), rrank=(5,), tt_rank=2,
                            seed=3)
    psis, omegas = dense_stream_sketch_bisect(X.data, ld.cores, rd.cores)
    _assert_sketch_close(psis, omegas, ref, atol=1e-11)


def test_bisect_2d_view_and_its_errors():
    X, ld, rd, ref = _setup()
    pivot = 1
    X2d = X.data.reshape(SHAPE[0] * SHAPE[1], -1)
    psis, omegas = dense_stream_sketch_bisect(
        X2d, ld.cores, rd.cores, pivot=pivot, shape=SHAPE, projector="auto"
    )
    _assert_sketch_close(psis, omegas, ref, atol=1e-11)
    # wrong pivot flattening must be rejected, not silently reinterpreted
    with pytest.raises(ValueError, match="flattening"):
        dense_stream_sketch_bisect(
            X.data.reshape(SHAPE[0], -1), ld.cores, rd.cores,
            pivot=pivot, shape=SHAPE,
        )
    with pytest.raises(ValueError, match="pivot"):
        dense_stream_sketch_bisect(X2d, ld.cores, rd.cores, shape=SHAPE)
    with pytest.raises(ValueError, match="does not match"):
        dense_stream_sketch_bisect(X.data, ld.cores, rd.cores,
                                   shape=(8, 5, 6, 8))
    with pytest.raises(ValueError, match="pivot must be"):
        dense_stream_sketch_bisect(X.data, ld.cores, rd.cores, pivot=3)
    with pytest.raises(ValueError, match="projector"):
        dense_stream_sketch_bisect(X.data, ld.cores, rd.cores,
                                   projector="pallas")


@pytest.mark.parametrize("engine", ["bisect", "fused"])
def test_slab_streaming_equals_jax_generic(engine):
    X, ld, rd, ref = _setup()
    cont = slab_stream_sketch(
        lambda i: X.data[i * 2: (i + 1) * 2], n_slabs=4, shape=SHAPE,
        left_cores=ld.cores, right_cores=rd.cores, engine=engine,
    )
    _assert_sketch_close(cont.Psi_cores, cont.Omega_mats, ref, atol=1e-11)


def test_slab_streaming_2d_slabs():
    X, ld, rd, ref = _setup()
    cont = slab_stream_sketch(
        lambda i: X.data[i * 2: (i + 1) * 2].reshape(2 * SHAPE[1], -1),
        n_slabs=4, shape=SHAPE, left_cores=ld.cores, right_cores=rd.cores,
        pivot=1,
    )
    _assert_sketch_close(cont.Psi_cores, cont.Omega_mats, ref, atol=1e-11)
    with pytest.raises(ValueError, match="divide"):
        slab_stream_sketch(lambda i: X.data, 3, SHAPE, ld.cores, rd.cores)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_dual_project_reference_vs_pallas_interpret(compute):
    from tt_sketch_tpu.kernels.pallas_project import dual_project as j_dual

    rng = np.random.default_rng(0)
    # S = 2 * block_n so the Pallas kernel sums per-j T partials
    P, S, r, rho = 512, 4096, 32, 64
    X = rng.normal(size=(P, S)).astype(np.float32)
    R = rng.normal(size=(S, rho)).astype(np.float32)
    L = rng.normal(size=(P, r)).astype(np.float32)
    mxu = jnp.bfloat16 if compute == "bf16" else jnp.float32
    T0, U0 = j_dual(jnp.asarray(X), jnp.asarray(R), jnp.asarray(L),
                    block_m=256, block_n=2048, mxu_dtype=mxu, interpret=True)
    T, U = dp.dual_project_reference(
        torch.from_numpy(X), torch.from_numpy(R), torch.from_numpy(L),
        compute=compute,
    )
    assert T.dtype == U.dtype == torch.float32
    np.testing.assert_allclose(T.numpy(), np.asarray(T0), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(U.numpy(), np.asarray(U0), rtol=2e-5, atol=2e-4)


def test_auto_projector_on_cpu_takes_plain_version():
    X, ld, rd, ref = _setup()
    before = _launches("dual_project")
    psis, omegas = dense_stream_sketch_bisect(
        X.data, ld.cores, rd.cores, pivot=1, projector="auto"
    )
    T, U = dp.dual_project(
        X.data.reshape(40, -1), torch.ones(42, 3, dtype=torch.float64),
        torch.ones(40, 2, dtype=torch.float64),
    )
    assert _launches("dual_project") == before
    _assert_sketch_close(psis, omegas, ref, atol=1e-11)
    np.testing.assert_allclose(
        T.numpy(), (X.data.reshape(40, -1) @ torch.ones(42, 3,
                                                        dtype=torch.float64)).numpy()
    )


def test_dual_project_raises_off_cpu_without_kernel():
    # a tensor that is neither on the CPU nor on CUDA never reaches the
    # plain version: the wrapper launches or raises
    X = torch.empty((64, 128), device="meta")
    R = torch.empty((128, 8), device="meta")
    L = torch.empty((64, 4), device="meta")
    before = _launches("dual_project")
    with pytest.raises(ValueError, match="CUDA device"):
        dp.dual_project(X, R, L)
    with pytest.raises(ValueError, match="compute"):
        dp.dual_project(X, R, L, compute="tf32")
    assert _launches("dual_project") == before


@pytest.mark.parametrize(
    "P, S, r, rho", [(512, 4096, 32, 64), (500, 4096, 32, 64),
                     (128, 4000, 3, 5), (32768, 16384, 32, 64)]
)
def test_fits_dual_project_parity(P, S, r, rho):
    from tt_sketch_tpu.kernels.pallas_project import fits_dual_project as jfits

    assert dp.fits_dual_project(P, S, r, rho) == jfits(P, S, r, rho)


@pytest.mark.parametrize("engine", ["fused", "bisect"])
def test_exact_recovery(engine):
    X, ld, rd, _ = _setup()
    fn = (dense_stream_sketch_fused if engine == "fused"
          else dense_stream_sketch_bisect)
    psis, omegas = fn(X.data, ld.cores, rd.cores)
    sk = SketchedTensorTrain(SketchContainer(psis, omegas), ld, rd)
    assert sk.to_tt().error(X, relative=True) < 1e-9


def test_float32_slab_stream_recovers():
    # the main path's configuration at a small size: f32 throughout,
    # 2-D pivot-1 slabs, rank-5 data sketched at ranks 32/64
    shape = (64, 16, 16, 16)
    f32 = torch.float32
    data = TensorTrain.random(shape, 5, seed=0, dtype=f32)
    ld = TensorTrainDRM(32, shape=shape, transpose=False, seed=1, dtype=f32)
    rd = TensorTrainDRM(64, shape=shape, transpose=True, seed=2, dtype=f32)
    full = data.to_dense()
    cont = slab_stream_sketch(
        lambda i: full[16 * i:16 * (i + 1)].reshape(256, 256), 4, shape,
        ld.cores, rd.cores, pivot=1,
    )
    assert cont.Psi_cores[0].dtype == f32
    err = SketchedTensorTrain(cont, ld, rd).to_tt().error(data, relative=True)
    assert err < 1e-4
