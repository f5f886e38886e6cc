"""TensorTrainDRM of the port against the JAX package's.

Tolerances: DRM cores are bit-identical for equal seeds; float64 sketch
contraction lists agree to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_sketch_torch import config
from tt_sketch_torch.drm import TensorTrainDRM
from tt_sketch_torch.formats import DenseTensor, TensorTrain
from tt_sketch_tpu.drm import TensorTrainDRM as JDRM
from tt_sketch_tpu.formats import DenseTensor as JDense
from tt_sketch_tpu.formats import TensorTrain as JTT

SHAPE = (8, 5, 6, 7)


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rank", [4, (3, 5, 2)])
def test_tt_drm_cores_bit_identical(transpose, dtype, rank):
    ours = TensorTrainDRM(rank, shape=SHAPE, transpose=transpose, seed=9,
                          dtype=getattr(torch, dtype))
    ref = JDRM(rank, shape=SHAPE, transpose=transpose, seed=9,
               dtype=getattr(jnp, dtype))
    assert ours.rank == ref.rank and ours.true_rank == ref.true_rank
    assert len(ours.cores) == len(ref.cores) == len(SHAPE) - 1
    for a, b in zip(ours.cores, ref.cores):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _inputs():
    tt = TensorTrain.random(SHAPE, 3, seed=0)
    jtt = JTT.random(SHAPE, 3, seed=0)
    return tt, jtt, DenseTensor(tt.to_dense()), JDense(jtt.to_dense())


def _assert_lists_close(ours, ref, atol=1e-12):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


@pytest.mark.parametrize("transpose", [False, True])
def test_sketch_dense_and_tt_match_jax(transpose):
    tt, jtt, X, JX = _inputs()
    ours = TensorTrainDRM((4, 5, 3), shape=SHAPE, transpose=transpose, seed=2)
    ref = JDRM((4, 5, 3), shape=SHAPE, transpose=transpose, seed=2)
    _assert_lists_close(ours.sketch_dense(X), ref.sketch_dense(JX))
    _assert_lists_close(ours.sketch_tt(tt), ref.sketch_tt(jtt))


@pytest.mark.parametrize("transpose", [False, True])
def test_sliced_drm_matches_jax(transpose):
    tt, jtt, X, JX = _inputs()
    start, end = (1, 2, 0), (4, 5, 3)
    ours = TensorTrainDRM((4, 5, 3), shape=SHAPE, transpose=transpose,
                          seed=2).slice(start, end)
    ref = JDRM((4, 5, 3), shape=SHAPE, transpose=transpose,
               seed=2).slice(start, end)
    assert ours.rank == ref.rank
    _assert_lists_close(ours.sketch_tt(tt), ref.sketch_tt(jtt))
    _assert_lists_close(ours.sketch_dense(X), ref.sketch_dense(JX))


def test_transpose_and_shape_check():
    d = TensorTrainDRM((4, 5, 3), shape=SHAPE, transpose=False, seed=2)
    jd = JDRM((4, 5, 3), shape=SHAPE, transpose=False, seed=2)
    assert d.T.rank == jd.T.rank and d.T.transpose
    with pytest.raises(ValueError, match="doesn't match"):
        d.sketch_tt(TensorTrain.random((8, 5, 6, 6), 2, seed=0))


def test_other_formats_are_later_slices():
    """CP and Tucker input have come: ``sketch_cp`` and ``sketch_tucker``
    equal the JAX package's (float64, 1e-12) for a left and a right DRM;
    a tensor of another shape still raises."""
    from tt_sketch_torch.formats import CPTensor, TuckerTensor
    from tt_sketch_torch.interop import tucker_tensor_from_numpy
    from tt_sketch_tpu.formats import CPTensor as JCP
    from tt_sketch_tpu.formats import TuckerTensor as JTucker

    cp, jcp = CPTensor.random(SHAPE, 4, seed=1), JCP.random(SHAPE, 4, seed=1)
    jtk = JTucker.random(SHAPE, (2, 3, 2, 3), seed=3)
    tk = tucker_tensor_from_numpy([np.asarray(U) for U in jtk.factors],
                                  np.asarray(jtk.core))
    for transpose in (False, True):
        d = TensorTrainDRM(3, shape=SHAPE, transpose=transpose, seed=2)
        jd = JDRM(3, shape=SHAPE, transpose=transpose, seed=2)
        _assert_lists_close(d.sketch_cp(cp), jd.sketch_cp(jcp))
        _assert_lists_close(d.sketch_tucker(tk), jd.sketch_tucker(jtk))
    for method, other in (("sketch_cp", CPTensor.random((8, 5, 6), 2)),
                          ("sketch_tucker",
                           TuckerTensor.random((8, 5, 6), 2))):
        with pytest.raises(ValueError, match="doesn't match"):
            getattr(d, method)(other)


def test_given_cores_set_the_device():
    ref = JDRM(3, shape=SHAPE, transpose=True, seed=4)
    from tt_sketch_torch.interop import from_numpy_cores

    cores = from_numpy_cores([np.asarray(c) for c in ref.cores])
    d = TensorTrainDRM(3, shape=SHAPE, transpose=True, seed=4, cores=cores)
    assert d.device == cores[0].device
    tt, jtt, _, _ = _inputs()
    _assert_lists_close(d.sketch_tt(tt), ref.sketch_tt(jtt))
