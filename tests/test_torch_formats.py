"""tt_sketch_torch.formats against tt_sketch_tpu.formats.

Tolerances: random cores are bit-identical (same host PCG64 stream and
rounding); contractions, norms and errors are float64 and held to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_sketch_torch import config
from tt_sketch_torch.formats import DenseTensor, TensorTrain
from tt_sketch_torch.formats import tt_ops
from tt_sketch_tpu.formats import DenseTensor as JDense
from tt_sketch_tpu.formats import TensorTrain as JTT

SHAPE = (6, 5, 7, 4)


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


@pytest.mark.parametrize("norm_goal", ["norm-1", "norm-preserve"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rank", [3, (2, 4, 3)])
def test_random_tt_cores_bit_identical(norm_goal, dtype, rank):
    ours = TensorTrain.random(
        SHAPE, rank, seed=11, norm_goal=norm_goal, dtype=getattr(torch, dtype)
    )
    ref = JTT.random(
        SHAPE, rank, seed=11, norm_goal=norm_goal, dtype=getattr(jnp, dtype)
    )
    assert ours.rank == ref.rank
    for a, b in zip(ours.cores, ref.cores):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_random_dense_bit_identical():
    ours = DenseTensor.random(SHAPE, seed=3)
    ref = JDense.random(SHAPE, seed=3)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(ours.T.data.numpy(), np.asarray(ref.T.data))


def _pair(seed, rank=3):
    return (
        TensorTrain.random(SHAPE, rank, seed=seed),
        JTT.random(SHAPE, rank, seed=seed),
    )


def test_to_dense_norm_dot_add_error():
    a, ja = _pair(0)
    b, jb = _pair(1, rank=2)
    np.testing.assert_allclose(
        a.to_dense().numpy(), np.asarray(ja.to_dense()), atol=1e-12
    )
    assert abs(a.norm() - ja.norm()) < 1e-12
    assert abs(a.dot(b) - ja.dot(jb)) < 1e-12
    np.testing.assert_allclose(
        a.add(b).to_dense().numpy(), np.asarray(ja.add(jb).to_dense()),
        atol=1e-12,
    )
    assert a.add(b).rank == ja.add(jb).rank
    assert abs(a.error(b) - ja.error(jb)) < 1e-12
    assert abs(a.error(b, relative=True, rmse=True)
               - ja.error(jb, relative=True, rmse=True)) < 1e-12
    np.testing.assert_allclose(
        (a * 2.5).to_dense().numpy(), np.asarray((ja * 2.5).to_dense()),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        a.T.to_dense().numpy(), np.asarray(ja.T.to_dense()), atol=1e-12
    )
    assert a.size == ja.size


def test_dense_algebra_matches_jax():
    a, ja = _pair(2)
    X = DenseTensor(a.to_dense())
    Y = DenseTensor(torch.from_numpy(np.random.default_rng(0).normal(size=SHAPE)))
    JX, JY = JDense(ja.to_dense()), JDense(jnp.asarray(Y.data.numpy()))
    assert abs(X.norm() - JX.norm()) < 1e-12
    assert abs(X.dot(Y) - JX.dot(JY)) < 1e-12
    assert abs(X.error(Y, relative=True) - JX.error(JY, relative=True)) < 1e-12
    # a TT against a dense tensor and against a numpy array
    assert abs(a.error(Y) - ja.error(JY)) < 1e-12
    assert abs(X.error(Y.data.numpy()) - JX.error(np.asarray(JY.data))) < 1e-12
    assert abs(X.error(Y, fast=True) - JX.error(JY, fast=True)) < 1e-12
    np.testing.assert_allclose(
        (-X / 2.0).data.numpy(), np.asarray((-JX / 2.0).data), atol=1e-12
    )


def test_partial_dense_and_orthogonalize():
    a, ja = _pair(4)
    for direction in ("lr", "rl"):
        for p, q in zip(a.partial_dense(direction), ja.partial_dense(direction)):
            np.testing.assert_allclose(p.numpy(), np.asarray(q), atol=1e-12)
    orth = a.orthogonalize()
    np.testing.assert_allclose(
        orth.to_dense().numpy(), a.to_dense().numpy(), atol=1e-12
    )
    for C in orth.cores[:-1]:
        mat = C.reshape(-1, C.shape[-1])
        np.testing.assert_allclose(
            (mat.T @ mat).numpy(), np.eye(mat.shape[1]), atol=1e-12
        )
    assert abs(float(tt_ops.tt_dot(a.cores, a.cores)) - a.norm() ** 2) < 1e-12


def test_zero_and_orthog_random():
    z = TensorTrain.zero(SHAPE, 3)
    assert z.rank == JTT.zero(SHAPE, 3).rank and z.norm() == 0.0
    o = TensorTrain.random(SHAPE, 3, seed=5, orthog=True)
    jo = JTT.random(SHAPE, 3, seed=5, orthog=True)
    assert o.rank == jo.rank
    assert abs(o.norm() - jo.norm()) < 1e-12


def test_lazy_sum_is_a_later_slice():
    """The lazy sum has come: ``a + a`` builds a ``TensorSum`` equal to the
    JAX package's (float64, 1e-12); a numpy array still is no
    ``DenseTensor``."""
    from tt_sketch_torch.formats import TensorSum
    from tt_sketch_tpu.formats import TensorSum as JSum

    a, ja = _pair(0)
    b, jb = _pair(1, rank=2)
    s, js = a + a, ja + ja
    assert isinstance(s, TensorSum) and isinstance(js, JSum)
    assert s.num_summands == js.num_summands == 2
    np.testing.assert_allclose(s.to_dense().numpy(),
                               np.asarray(js.to_dense()), atol=1e-12)
    d = (a - b).to_dense().numpy()
    np.testing.assert_allclose(d, np.asarray((ja - jb).to_dense()),
                               atol=1e-12)
    assert s.dot(b) == pytest.approx(js.dot(jb), abs=1e-12)
    assert b.dot(s) == pytest.approx(jb.dot(js), abs=1e-12)
    with pytest.raises(TypeError, match="torch.Tensor"):
        DenseTensor(np.zeros(SHAPE))
