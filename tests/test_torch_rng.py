"""The host oracles and the dense helper of ``tt_sketch_torch.rng`` against
the JAX package's (``tt_sketch_tpu/rng/hash_rng.py``): ``inds_to_normal_np``,
``inds_to_sparse_sign_np`` and ``lazy_gaussian_matrix``.

The hash pipeline (flattened index, column salt, splitmix64, the 52-bit
uniform) is the same integer arithmetic in both packages, so hashed bits,
uniforms, the sparse-sign rows and everything computed by scipy's ``ndtri``
on the host are equal bit for bit.  The torch backend of
``lazy_gaussian_matrix`` takes ``torch.special.ndtri`` where the JAX
package takes ``jax.scipy.special.ndtri``: its uniforms are equal bit for
bit and its normals within ``NDTRI_TOL`` (1e-15 absolute, the two ``ndtri``
implementations' last bits at |g| <= 8.3, as
``tests/test_torch_uniform.py``'s ``HASH_TOL``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_sketch_torch.rng as TR
import tt_sketch_tpu.rng as JR
from tt_sketch_torch.rng import hash_rng as TH
from tt_sketch_tpu.rng import hash_rng as JH

NDTRI_TOL = 1e-15
SHAPE = (11, 9, 30, 25)


def _indices(n, seed=3, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, n) for s in shape]).astype(np.int64)


def test_rng_exports_the_jax_packages_host_names():
    for name in ("hash_int_np", "inds_to_normal_np", "inds_to_sparse_sign_np",
                 "lazy_gaussian_matrix"):
        assert hasattr(JR, name) and hasattr(TR, name), name


@pytest.mark.parametrize("rank_min,rank_max,seed", [
    (0, 7, 5), (3, 11, 12345), (0, 1, (1 << 63) + 17), (5, 20, 0)],
    ids=["0-7", "3-11", "seed above 2^63", "5-20 seed 0"])
def test_inds_to_normal_np_bit_for_bit(rank_min, rank_max, seed):
    idx = _indices(2000)
    got = TR.inds_to_normal_np(idx, SHAPE, rank_min, rank_max, seed)
    ref = JR.inds_to_normal_np(idx, SHAPE, rank_min, rank_max, seed)
    assert got.dtype == np.float64 and got.shape == (2000,
                                                     rank_max - rank_min)
    assert np.array_equal(got, ref)
    # the hashed bits and uniforms under it
    flat = TH._flat_index_np(idx, SHAPE)
    bits = TH._hash_bits_np(flat, rank_min, rank_max, seed)
    assert np.array_equal(bits, JH._hash_bits_np(flat, rank_min, rank_max,
                                                 seed))
    # the torch parity path draws the same uniforms
    u = TH.uniform_from_bits(torch.from_numpy(bits.view(np.int64)))
    assert np.array_equal(u.numpy(), TH._uniform_from_bits_np(bits))
    ours = TH.inds_to_normal(torch.from_numpy(idx), SHAPE, rank_min,
                             rank_max, seed)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=NDTRI_TOL)


@pytest.mark.parametrize("rank,rank_min,rank_max,nnz", [
    (10, 0, 10, 3), (13, 2, 9, 5), (8, 0, 8, 8), (40, 30, 40, 4),
    (1, 0, 1, 1)], ids=["10 of 3", "slice 2-9 of 13", "full 8",
                        "slice 30-40 of 40", "rank 1"])
def test_inds_to_sparse_sign_np_bit_for_bit(rank, rank_min, rank_max, nnz):
    idx = _indices(1500, seed=4)
    got = TR.inds_to_sparse_sign_np(idx, SHAPE, rank, rank_min, rank_max,
                                    nnz, 77)
    ref = JR.inds_to_sparse_sign_np(idx, SHAPE, rank, rank_min, rank_max,
                                    nnz, 77)
    assert got.dtype == np.int16 and got.shape == (1500, rank_max - rank_min)
    assert np.array_equal(got, ref)
    full = TR.inds_to_sparse_sign_np(idx, SHAPE, rank, 0, rank, nnz, 77)
    assert (np.abs(full).sum(axis=1) == nnz).all()
    # the torch parity path shuffles the same way
    ours = TH.inds_to_sparse_sign(torch.from_numpy(idx), SHAPE, rank,
                                  rank_min, rank_max, nnz, 77)
    assert np.array_equal(ours.numpy(), ref.astype(np.float64))


@pytest.mark.parametrize("n_rows,rank_min,rank_max,seed", [
    (11 * 9, 0, 6, 2), (11 * 9 * 30, 4, 9, 31), (1, 0, 3, 0)],
    ids=["99 x 6", "2970 x 5 from 4", "one row"])
def test_lazy_gaussian_matrix(n_rows, rank_min, rank_max, seed):
    ref_np = JR.lazy_gaussian_matrix(n_rows, SHAPE, rank_min, rank_max, seed,
                                     backend="np")
    got_np = TR.lazy_gaussian_matrix(n_rows, SHAPE, rank_min, rank_max, seed,
                                     backend="np")
    assert np.array_equal(got_np, ref_np)
    ref = np.asarray(JR.lazy_gaussian_matrix(n_rows, SHAPE, rank_min,
                                             rank_max, seed))
    got = TR.lazy_gaussian_matrix(n_rows, SHAPE, rank_min, rank_max, seed,
                                  device="cpu")
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=NDTRI_TOL)
    # the block is inds_to_normal on the unraveled index grid
    grid = np.stack(np.unravel_index(np.arange(n_rows), SHAPE, order="F"))
    np.testing.assert_array_equal(
        got_np, TR.inds_to_normal_np(grid, SHAPE, rank_min, rank_max, seed))
    ju = np.asarray(JH.uniform_from_bits(JH._hash_bits(
        jnp.arange(n_rows, dtype=jnp.uint64), rank_min, rank_max, seed)))
    tu = TH.uniform_from_bits(TH._hash_bits(
        torch.arange(n_rows, dtype=torch.int64), rank_min, rank_max, seed))
    assert np.array_equal(tu.numpy(), ju)


def test_lazy_gaussian_matrix_has_no_jax_backend():
    with pytest.raises(ValueError, match="backend"):
        TR.lazy_gaussian_matrix(4, SHAPE, 0, 2, 1, backend="jax")
