"""The segment kernel (``csrc/segment_psi.cu``) on a CUDA card, against its
plain version: uber's mode-1 Ψ at the benchmark's ranks (24 rows x 20 x 40,
planned within 113 KB), the C entry's fit against ``segment_fits``, and the
launch geometry of the squeezed shapes and of the shapes whose plan stays as
it was.

This file imports no JAX, so that it runs on a machine with a card:
``python3 -m pytest --noconftest tests/test_torch_segment_psi_card.py``.
Without a card every test skips.

Tolerances as in ``test_torch_segment_psi.py``'s card test: relative
Frobenius ``1e-12`` in float64 and ``2e-5`` in float32 (sums of a few
thousand terms in another order).
"""
import numpy as np
import pytest
import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.kernels import segment_psi as SG
from tt_sketch_torch.kernels import sketch_kernels as K

#: uber's nonzeros and its mode 1's runs (1,248 runs of about 2,652)
NNZ, RUN = 3_309_696, 2652


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")


def _mode_1(dtype, nnz=NNZ, seed=5):
    """uber's mode-1 operands on the card: left (20, nnz), right (40, nnz),
    entries, and int64 indices over 24 rows in runs of 2/3 to 4/3 of
    ``RUN``, with an index outside the mode inside two of the runs."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2 * RUN // 3, 4 * RUN // 3 + 1,
                           3 * nnz // (2 * RUN) + 1)
    idx = np.repeat(rng.integers(0, 24, lengths.size), lengths)[:nnz]
    idx[nnz // 3], idx[nnz // 2] = 24, -1
    g = torch.Generator(device="cuda").manual_seed(seed)
    left, right = (torch.randn((r, nnz), generator=g, device="cuda",
                               dtype=dtype) for r in (20, 40))
    ent = torch.randn(nnz, generator=g, device="cuda", dtype=dtype)
    return left, right, ent, torch.from_numpy(idx).cuda(), 24


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ubers_mode_1_matches_the_plain_version(card, dtype):
    args = _mode_1(dtype)
    before = profiling.counters()
    got = K._psi_sparse_segment(*args).permute(1, 0, 2)
    after = profiling.counters()
    for name, change in (("launches.psi_segment", 1),
                         ("fallbacks.psi_index_add", 0)):
        assert after.get(name, 0) - before.get(name, 0) == change, name
    ref = SG.psi_segment_reference(*args)
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) <= tol
    assert torch.equal(got, SG.psi_segment(*args))  # a fixed order


def _boundary(elem, r1, r2):
    """The most rows ``segment_fits`` takes at ranks r1, r2."""
    lo, hi = 1, 1
    while SG._fits(elem, hi, r1, r2):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if SG._fits(elem, mid, r1, r2) else (lo, mid)
    return lo


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("r1, r2", [(1, 1), (1, 40), (20, 40), (10, 20),
                                    (4, 8), (3, 700), (1, 1500)])
def test_c_fit_agrees_with_segment_fits(card, elem, r1, r2):
    lib = SG._library()
    n = _boundary(elem, r1, r2)
    for n_mu in (1, n, n + 1):
        assert bool(lib.tt_segment_psi_fits(elem, n_mu, r1, r2)) == \
            SG._fits(elem, n_mu, r1, r2), n_mu
    assert not lib.tt_segment_psi_fits(elem, 1, 1, SG.MAX_PAIRS + 1)
    assert not lib.tt_segment_psi_fits(elem, 0, r1, r2)


#: (n_mu, r1, r2) -> the float32 plan of the kernel before the squeezed
#: plan (96 KB, steps of 128 nonzeros), worked out from its plan_of: uber's
#: STTA mode 0 and HMT modes 0 and 1, and the 10/20 mode 1 of the sum and
#: sharded paths
KEPT = {
    (183, 1, 40): dict(ta=1, tb=1, tiles_a_block=40, threads=64,
                       smem_bytes=76960),
    (183, 1, 20): dict(ta=1, tb=1, tiles_a_block=20, threads=32,
                       smem_bytes=41200),
    (24, 20, 20): dict(ta=2, tb=4, tiles_a_block=50, threads=64,
                       smem_bytes=85024),
    (24, 10, 20): dict(ta=2, tb=4, tiles_a_block=25, threads=32,
                       smem_bytes=55264),
}


@pytest.mark.parametrize("shape", list(KEPT))
def test_unsqueezed_shapes_keep_their_plan(card, shape):
    plan = SG.segment_plan(4, *shape)
    want = dict(KEPT[shape], tk=128, grid_y=1, fits=True)
    assert {k: plan[k] for k in want} == want


@pytest.mark.parametrize("elem, tiles_a_block, threads, tk, grid_y, "
                         "smem_bytes", [(4, 100, 128, 64, 1, 111648),
                                        (8, 69, 96, 8, 2, 115328)])
def test_ubers_mode_1_takes_the_squeezed_plan(card, elem, tiles_a_block,
                                              threads, tk, grid_y,
                                              smem_bytes):
    # 24 rows x 100 micro-tiles of 2 x 4: 76.8 KB of float32 bins leave 96
    # KB a ring of 32 nonzeros a step, 113 KB (two blocks an SM) a ring of
    # 64; float64 bins take two blocks of micro-tiles at either budget
    plan = SG.segment_plan(elem, 24, 20, 40)
    want = dict(tiles_a_block=tiles_a_block, threads=threads, tk=tk,
                grid_y=grid_y, smem_bytes=smem_bytes, tiles=100, fits=True)
    assert {k: plan[k] for k in want} == want


def test_a_mildly_squeezed_shape_takes_two_blocks_an_sm(card):
    # 81 rows x 25 micro-tiles of 2 x 4: 96 KB left a step of 112; 113 KB
    # holds 128, and two such blocks share an SM
    plan = SG.segment_plan(4, 81, 10, 20)
    want = dict(tiles_a_block=25, threads=32, tk=128, grid_y=1,
                smem_bytes=100864, fits=True)
    assert {k: plan[k] for k in want} == want
