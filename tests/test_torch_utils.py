"""tt_sketch_torch.utils against tt_sketch_tpu.utils on the same inputs.

Tolerances: rank bookkeeping and the host RNG are exact (bit-identical);
the pinv products are float64 SVD solves, held to atol 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_sketch_torch import config
from tt_sketch_torch import utils as tu
from tt_sketch_tpu import utils as ju


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


@pytest.mark.parametrize(
    "dims, ranks",
    [
        ((8, 5, 6, 7), (4, 4, 4)),
        ((2, 3, 50, 2), (10, 10, 10)),
        ((3, 3), (20,)),
        ((4, 100, 4, 4, 4), (64, 64, 64, 64)),
    ],
)
def test_trim_and_process_rank_equal(dims, ranks):
    assert tu.trim_ranks(dims, ranks) == ju.trim_ranks(dims, ranks)
    for trim in (False, True):
        assert tu.process_tt_rank(ranks, dims, trim) == ju.process_tt_rank(
            ranks, dims, trim
        )
        assert tu.process_tt_rank(5, dims, trim) == ju.process_tt_rank(
            5, dims, trim
        )


def test_process_rank_rejects_wrong_length():
    with pytest.raises(ValueError, match="right number"):
        tu.process_tt_rank((2, 2), (3, 3, 3, 3), trim=False)


@pytest.mark.parametrize("mode", [0, 2, (0, 1), (1, 3), (0, 1, 2)])
@pytest.mark.parametrize("mat_shape", [False, True])
def test_matricize_equal(mode, mat_shape):
    A = np.random.default_rng(0).normal(size=(3, 4, 5, 6))
    ours = tu.matricize(torch.from_numpy(A), mode, mat_shape=mat_shape)
    ref = ju.matricize(jnp.asarray(A), mode, mat_shape=mat_shape)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", [0, 1, 3])
def test_dematricize_roundtrip_equal(mode):
    shape = (3, 4, 5, 6)
    A = np.random.default_rng(1).normal(size=shape)
    mat = tu.matricize(torch.from_numpy(A), mode, mat_shape=True)
    back = tu.dematricize(mat, mode, shape)
    ref = ju.dematricize(jnp.asarray(np.asarray(mat)), mode, shape)
    np.testing.assert_array_equal(back.numpy(), A)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_random_normal_bit_identical(dtype, seed):
    ours = tu.random_normal((13, 7), seed=seed, dtype=getattr(torch, dtype))
    ref = ju.random_normal((13, 7), seed=seed, dtype=getattr(jnp, dtype))
    assert ours.dtype == getattr(torch, dtype)
    assert ours.device.type == "cpu"
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _rank_deficient(m, n, rank, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, rank)) @ rng.normal(size=(rank, n))


@pytest.mark.parametrize("shape, rank", [((4, 7), 3), ((7, 7), 5), ((6, 9), 6)])
def test_pinv_products_match_jax(shape, rank):
    rng = np.random.default_rng(2)
    Omega = _rank_deficient(*shape, rank, seed=3)
    A = rng.normal(size=(11, shape[1])) @ np.linalg.pinv(Omega) @ Omega
    B = rng.normal(size=(shape[0], 5))
    right = tu.right_mul_pinv(torch.from_numpy(A), torch.from_numpy(Omega))
    left = tu.left_mul_pinv(torch.from_numpy(Omega), torch.from_numpy(B))
    np.testing.assert_allclose(
        right.numpy(),
        np.asarray(ju.right_mul_pinv(jnp.asarray(A), jnp.asarray(Omega))),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        left.numpy(),
        np.asarray(ju.left_mul_pinv(jnp.asarray(Omega), jnp.asarray(B))),
        atol=1e-12,
    )


def test_lstsq_drops_noise_directions():
    # the exact-recovery regime: a rank-3 Ω plus rounding-level noise must
    # be solved as rank 3 (gels-style full-rank solves would blow up)
    Omega = _rank_deficient(4, 7, 3, seed=4)
    noisy = Omega + 1e-17 * np.random.default_rng(5).normal(size=Omega.shape)
    X = np.random.default_rng(6).normal(size=(4, 2))
    sol = tu._lstsq(torch.from_numpy(noisy), torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(sol, np.linalg.pinv(Omega) @ X, atol=1e-10)
