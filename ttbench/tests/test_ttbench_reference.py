"""The plain reference against tt_sketch_torch's plain CPU versions at
tiny sizes: the frozen hash contract, the sparse STTA and HMT sketches and
the dense slab stream, each within float32 rounding."""
import numpy as np
import pytest
import torch

from ttbench import check
from ttbench.reference import dense_stream, hashrows, sparse
from ttbench.tests.tiny import SHAPE


def coo(nnz=2000, seed=3):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, n, nnz) for n in SHAPE]).astype(np.int64)
    return torch.from_numpy(idx), torch.from_numpy(
        rng.standard_normal(nnz)).to(torch.float32)


def program_tensor(idx, vals):
    from tt_sketch_torch.formats.sparse import SparseTensor

    return SparseTensor(SHAPE, idx, vals, device="cpu").with_psi_plan(
        threshold=12)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
def test_hash_rows_match_the_program(seed):
    from tt_sketch_torch.kernels.lazy_gaussian import lazy_gaussian
    from tt_sketch_torch.kernels.sparse_sign import sparse_sign_rows
    from tt_sketch_torch.rng.hash_rng import drm_salts, flat_index

    idx, _ = coo(500)
    for k in range(3):
        flat = flat_index(idx[: k + 1], SHAPE[: k + 1])
        assert torch.equal(flat, hashrows.flat_prefix(idx[: k + 1],
                                                      SHAPE[: k + 1]))
        step = hashrows.step_seed(seed, k)
        g = lazy_gaussian(flat, drm_salts(0, 7, step))
        assert torch.allclose(g.double(), hashrows.gaussian_rows(flat, 7,
                                                                 step),
                              atol=2e-6, rtol=0)
        s = sparse_sign_rows(flat, drm_salts(0, 9, step), 9, 9, 0, 9)
        assert torch.equal(s.double(), hashrows.sign_rows(flat, 9, 9, step))


def test_right_seed_matches_the_program():
    from tt_sketch_torch.engine.sketch import _derive_right_seed

    for seed in (0, 1, 2 ** 32 - 2, 2 ** 31 + 17):
        assert hashrows.right_seed(seed, 4) == _derive_right_seed(seed, 4)


@pytest.mark.parametrize("kinds", [("gaussian", "gaussian"),
                                   ("sign", "sign"), ("gaussian", "sign")])
def test_stta_matches_the_program(kinds):
    from tt_sketch_torch import stream_sketch
    from tt_sketch_torch.drm import SparseGaussianDRM, SparseSignDRM

    types = {"gaussian": SparseGaussianDRM, "sign": SparseSignDRM}
    idx, vals = coo()
    sk = stream_sketch(program_tensor(idx, vals), 3, 5, seed=99,
                       left_drm_type=types[kinds[0]],
                       right_drm_type=types[kinds[1]], dtype=torch.float32,
                       device="cpu")
    psis, omegas, cores = sparse.stta(idx, vals, SHAPE, 3, 5, 99, *kinds)
    got = {"sketch": (sk.Psi_cores, sk.Omega_mats), "tt": sk.to_tt().cores}
    nums = check.compare(got, {"sketch": (psis, omegas), "tt": cores}, idx)
    assert nums["sketch_rel"] < 2e-6 and nums["tt_rel"] < 2e-5


def test_hmt_matches_the_program():
    from tt_sketch_torch import hmt_sketch
    from tt_sketch_torch.drm import SparseGaussianDRM

    idx, vals = coo()
    tt = hmt_sketch(program_tensor(idx, vals), 3, seed=5,
                    drm_type=SparseGaussianDRM, dtype=torch.float32,
                    device="cpu")
    cores = sparse.hmt(idx, vals, SHAPE, 3, 5, "gaussian")
    nums = check.compare({"sketch": None, "tt": tt.cores},
                         {"sketch": None, "tt": cores}, idx)
    assert nums["tt_rel"] < 2e-5


def test_dense_stream_matches_the_program():
    from tt_sketch_torch.kernels.dense_engine import slab_stream_sketch

    shape, n_slabs = (6, 5, 4, 3), 3
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    lc, rc = dense_stream.drm_cores(shape, 3, 4, 11, "cpu")
    c = slab_stream_sketch(lambda i: x[2 * i:2 * i + 2], n_slabs, shape,
                           lc, rc, engine="bisect", projector="kernel")
    psis, omegas = dense_stream.sketch(lambda i: x[2 * i:2 * i + 2],
                                       n_slabs, shape, lc, rc)
    for got, ref in zip(c.Psi_cores + c.Omega_mats, psis + omegas):
        assert got.shape == ref.shape
        assert torch.allclose(got.double(), ref, atol=1e-5, rtol=1e-5)


def test_tf32_rounding():
    from ttbench.reference.lowp import round_tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -(1.0 + 2 ** -11)])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                      -(1.0 + 2 ** -10)]
