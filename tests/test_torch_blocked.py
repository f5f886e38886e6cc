"""Blocked sketches (``blocked_stream_sketch``), rank growth
(``SketchedTensorTrain.increase_rank``) and ``get_drm_capabilities`` of the
port, against the JAX package.

Tolerances, with their reasons:

- float64: 1e-12 relative to the largest value (the same rows, each block
  a sub-sketch whose sums run in another order);
- float32 through the fused kernels' plain versions against the Pallas
  kernels in interpret mode: ``3e-5·max|ref|`` (float32 sums in another
  order, as ``tests/test_torch_sparse_sketch.py``);
- exact recovery after growth: 1e-8 relative error, as
  ``tests/test_sketching.py::test_rank_increase_consistency``.
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
from tt_sketch_torch.engine.dispatch import SketchMethod, general_sketch
from tt_sketch_torch.engine.sketch import (
    blocked_stream_sketch,
    get_drm_capabilities,
    stream_sketch,
)
from tt_sketch_torch.formats import SparseTensor, TensorTrain
from tt_sketch_tpu.drm import DenseGaussianDRM as JDG
from tt_sketch_tpu.drm import SparseGaussianDRM as JSG
from tt_sketch_tpu.drm import SparseSignDRM as JSS
from tt_sketch_tpu.drm import TensorTrainDRM as JTT
from tt_sketch_tpu.engine.dispatch import SketchMethod as JMethod
from tt_sketch_tpu.engine.dispatch import general_sketch as j_general
from tt_sketch_tpu.engine.sketch import (
    blocked_stream_sketch as j_blocked,
)
from tt_sketch_tpu.engine.sketch import (
    get_drm_capabilities as j_capabilities,
)
from tt_sketch_tpu.formats import SparseTensor as JST
from tt_sketch_tpu.formats import TensorTrain as JTrain

SHAPE = (5, 6, 7, 4)
DRMS = {"gauss": (SparseGaussianDRM, JSG), "sign": (SparseSignDRM, JSS),
        "tt": (TensorTrainDRM, JTT), "dense": (DenseGaussianDRM, JDG)}
D = len(SHAPE)
LEFT_SLICES = [(0,) * 3, (2,) * 3, (5,) * 3]
RIGHT_SLICES = [(0,) * 3, (3,) * 3, (6,) * 3, (8,) * 3]


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("TT_SKETCH_TPU_FORCE_TPU", "1")
    monkeypatch.setenv("TT_SKETCH_TPU_PALLAS_INTERPRET", "1")


def _parts(sk):
    return list(sk.Psi_cores) + list(sk.Omega_mats)


def _close(ours, ref, rel=1e-12):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=rel * max(np.abs(b).max(), 1e-300))


def _low_rank_sparse(shape=SHAPE, rank=2, seed=2):
    """A TT of rank ``rank`` as a COO tensor over all its entries (the JAX
    package's ``DenseTensor.to_sparse`` of it), for both packages."""
    dense = np.asarray(JTrain.random(shape, rank, seed=seed).to_dense())
    idx = np.stack(np.unravel_index(np.arange(dense.size), shape))
    ent = dense.reshape(-1)
    return SparseTensor(shape, idx, ent), JST(shape, idx, ent)


def _drm_pair(name, left_rank=(5,) * 3, right_rank=(8,) * 3, dtype="float64",
              **kw):
    ours, ref = DRMS[name]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    return (ours(left_rank, SHAPE, False, seed=21, dtype=tdt, **kw),
            ours(right_rank, SHAPE, True, seed=22, dtype=tdt, **kw),
            ref(left_rank, SHAPE, False, seed=21, dtype=jdt, **kw),
            ref(right_rank, SHAPE, True, seed=22, dtype=jdt, **kw))


@pytest.mark.parametrize("drm", ["gauss", "sign", "tt", "dense"])
def test_blocked_sketch_equivalence(drm):
    """``tests/test_sketching.py::test_blocked_sketch_equivalence``: any
    rank-slicing grid reproduces the unblocked sketch, and the blocked
    sketch equals the JAX package's."""
    t, jt = _low_rank_sparse()
    ld, rd, jld, jrd = _drm_pair(drm)
    whole = general_sketch(t, ld, rd, SketchMethod.streaming)
    blocked = blocked_stream_sketch(t, ld, rd, LEFT_SLICES, RIGHT_SLICES)
    jblocked = j_blocked(jt, jld, jrd, LEFT_SLICES, RIGHT_SLICES)
    assert blocked.left_rank == jblocked.left_rank == (5,) * 3
    assert blocked.right_rank == jblocked.right_rank == (8,) * 3
    _close(_parts(blocked), [p.numpy() for p in _parts(whole)])
    _close(_parts(blocked), _parts(jblocked))


@pytest.mark.parametrize("drm", ["tt", "dense"])
def test_blocked_sketch_of_tt_input(drm):
    t, jt = TensorTrain.random(SHAPE, 3, seed=1), JTrain.random(SHAPE, 3,
                                                                seed=1)
    ld, rd, jld, jrd = _drm_pair(drm, (4, 6, 5), (7, 9, 8))
    left = [(0, 0, 0), (1, 3, 2), (4, 6, 5)]
    right = [(0, 0, 0), (7, 9, 8)]
    blocked = blocked_stream_sketch(t, ld, rd, left, right)
    whole = general_sketch(t, ld, rd, SketchMethod.streaming)
    _close(_parts(blocked), [p.numpy() for p in _parts(whole)])
    _close(_parts(blocked), _parts(j_blocked(jt, jld, jrd, left, right)))


@pytest.mark.parametrize("pair", ["gauss", "sign"])
def test_f32_blocked_sketch_matches_pallas(pallas_interpret, pair):
    """float32 blocks through the fused kernels (rank-sliced salts), planned
    as FROSTT-uber is (modes 2 and 3), against the Pallas kernels."""
    rng = np.random.default_rng(6)
    shape = (11, 9, 30, 25)
    idx = np.stack([rng.integers(0, s, 2500) for s in shape])
    ent = rng.standard_normal(2500).astype(np.float32)
    t = SparseTensor(shape, idx, ent).with_psi_plan(threshold=12, chunk=128)
    jt = JST(shape, idx, ent).with_psi_plan(indices=idx, entries=ent,
                                            threshold=12, chunk=128)
    dt, jdt = DRMS[pair]
    ld = dt((5,) * 3, shape, False, seed=21, dtype=torch.float32)
    rd = dt((8,) * 3, shape, True, seed=22, dtype=torch.float32)
    jld = jdt((5,) * 3, shape, False, seed=21, dtype=jnp.float32)
    jrd = jdt((8,) * 3, shape, True, seed=22, dtype=jnp.float32)
    blocked = blocked_stream_sketch(t, ld, rd, LEFT_SLICES, RIGHT_SLICES)
    whole = general_sketch(t, ld, rd, SketchMethod.streaming)
    _close(_parts(blocked), _parts(j_blocked(jt, jld, jrd, LEFT_SLICES,
                                             RIGHT_SLICES)), 3e-5)
    _close(_parts(blocked), [p.numpy() for p in _parts(whole)], 3e-5)


@pytest.mark.parametrize("drm", ["gauss", "dense"])
@pytest.mark.parametrize("shape", [SHAPE, (3, 4, 5, 2)])
def test_rank_increase_consistency(drm, shape):
    """``tests/test_sketching.py::test_rank_increase_consistency``: the old
    container is block (0, 0) of the grown one, the grown sketch equals a
    sketch from scratch with the grown DRMs and the JAX package's grown
    sketch.  On (3, 4, 5, 2) ``stream_sketch`` trims the left rank and
    ``increase_rank`` does not, as in the JAX package."""
    dt, jdt = DRMS[drm]
    t, jt = _low_rank_sparse(shape)
    small = stream_sketch(t, 4, 6, seed=31, left_drm_type=dt,
                          right_drm_type=dt)
    jsmall = jts.stream_sketch(jt, 4, 6, seed=31, left_drm_type=jdt,
                               right_drm_type=jdt)
    assert small.left_rank == jsmall.left_rank
    big = small.increase_rank(t, 6, 9)
    jbig = jsmall.increase_rank(jt, 6, 9)
    assert big.left_rank == jbig.left_rank == (6,) * 3
    assert big.right_rank == jbig.right_rank == (9,) * 3
    _close(_parts(big), _parts(jbig))
    scratch = stream_sketch(t, 6, 9, left_drm=big.left_drm,
                            right_drm=big.right_drm)
    _close(_parts(big), [p.numpy() for p in _parts(scratch)], 1e-10)
    for mu, (P, Q) in enumerate(zip(big.Psi_cores, small.Psi_cores)):
        r1, _, r2 = Q.shape
        assert torch.equal(P[:r1, :, :r2], Q), mu
    for O, Q in zip(big.Omega_mats, small.Omega_mats):
        assert torch.equal(O[: Q.shape[0], : Q.shape[1]], Q)
    assert big.to_tt().error(t, relative=True) < 1e-8


def test_rank_increase_needs_a_growable_drm():
    """A TT-DRM slices but does not grow: both packages raise the same
    ``AttributeError`` from ``increase_rank``."""
    t, jt = _low_rank_sparse()
    sk = stream_sketch(t, 4, 6, seed=3)
    jsk = jts.stream_sketch(jt, 4, 6, seed=3)
    for s, x in ((sk, t), (jsk, jt)):
        with pytest.raises(AttributeError, match="increase_rank"):
            s.increase_rank(x, 5, 8)


def test_blocked_sketch_of_a_sum():
    """Blocks of a split sum (each block a sum over the shards)."""
    t, jt = _low_rank_sparse()
    ld, rd, jld, jrd = _drm_pair("gauss")
    blocked = blocked_stream_sketch(t.split(3), ld, rd, LEFT_SLICES,
                                    RIGHT_SLICES)
    _close(_parts(blocked), _parts(j_blocked(jt.split(3), jld, jrd,
                                             LEFT_SLICES, RIGHT_SLICES)))


def test_capabilities_matrix():
    """``tests/test_sketching.py::test_capabilities_matrix``: the port's
    dict equals the JAX package's."""
    caps = get_drm_capabilities()
    assert caps == j_capabilities()
    assert caps["DenseGaussianDRM"]["CanIncreaseRank"]
    assert not caps["SparseSignDRM"]["CanIncreaseRank"]
    assert not caps["TensorTrainDRM"]["CanIncreaseRank"]
    assert caps["TensorTrainDRM"]["CansketchTucker"]


# -- the sign DRM's nnz fault (ROADMAP Queue 3, open fault 1) -------------------

@pytest.mark.parametrize("ranks", [((5, 3, 4), (8, 6, 7)),
                                   ((3, 5, 4), (7, 9, 8))])
def test_blocked_sign_sketch_with_default_nnz_equals_unblocked(ranks):
    """No blocked configuration triggers the fault with the default
    ``nnz``: ``slice`` rebuilds ``nnz`` from ``true_rank`` in the slice's
    orientation, so unequal ranks per mode on both sides give the unblocked
    sketch in both packages, and the same sketch in each."""
    t, jt = _low_rank_sparse()
    ld, rd, jld, jrd = _drm_pair("sign", *ranks)
    left = [(0, 0, 0), (1, 2, 1), ranks[0]]
    right = [(0, 0, 0), (3, 2, 4), ranks[1]]
    whole = general_sketch(t, ld, rd, SketchMethod.streaming)
    jwhole = j_general(jt, jld, jrd, JMethod.streaming)
    blocked = blocked_stream_sketch(t, ld, rd, left, right)
    jblocked = j_blocked(jt, jld, jrd, left, right)
    _close(_parts(blocked), [p.numpy() for p in _parts(whole)])
    for a, b in zip(_parts(jblocked), _parts(jwhole)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-12 * np.abs(np.asarray(b)).max())
    _close(_parts(blocked), _parts(jblocked))


def test_blocked_sign_sketch_drops_an_explicit_nnz_in_both_packages():
    """With an explicit ``num_non_zero_per_row`` the blocks' DRMs draw
    ``true_rank`` non-zeros (``slice`` drops the value), so the blocked
    sketch is not the unblocked one, in both packages alike: the port
    keeps the JAX package's behaviour, fault included."""
    t, jt = _low_rank_sparse()
    nnz = (2, 2, 2)
    ld, rd, jld, jrd = _drm_pair("sign", num_non_zero_per_row=nnz)
    for d, jd in ((ld, jld), (rd, jrd)):
        assert d.nnz == jd.nnz == nnz
        full = d.true_rank[::-1] if d.transpose else d.true_rank
        s, js = d.slice((0,) * 3, full), jd.slice((0,) * 3, full)
        assert s.nnz == js.nnz == s.true_rank != nnz
    whole = general_sketch(t, ld, rd, SketchMethod.streaming)
    blocked = blocked_stream_sketch(t, ld, rd, LEFT_SLICES, RIGHT_SLICES)
    jblocked = j_blocked(jt, jld, jrd, LEFT_SLICES, RIGHT_SLICES)
    _close(_parts(blocked), _parts(jblocked))
    assert not all(torch.allclose(a, b) for a, b in zip(_parts(blocked),
                                                        _parts(whole)))
