"""The sequential sketches of the port (``hmt_sketch``, ``orthogonal_sketch``)
and the sparse Ψ/Ω dispatch behind them, against the JAX package.

Reference side: the JAX entry points on the same numpy data and seeds (both
packages derive equal DRMs from equal seeds); float32 runs the Pallas
kernels in interpret mode (``TT_SKETCH_TPU_FORCE_TPU=1``,
``TT_SKETCH_TPU_PALLAS_INTERPRET=1``), as the JAX package's own tests do.
A QR sits between the modes of a sequential sweep and its column signs are
the library's choice, so cores are never compared: the recovered tensors
are, as dense arrays.  Tolerances, with their reasons:

- float64: ``1e-10·max|ref|`` (the same rows and sums in another order,
  through three QRs and, for OTTS, three pseudo-inverses);
- float32: ``2e-4·max|ref|``, what ``tests/test_sparse_plan.py::
  test_sequential_methods_fused_right`` allows between the JAX package's
  own float32 and float64 sweeps;
- float32 Ψ/Ω of a streaming sketch: ``3e-5·max|ref|`` (float32 sums in
  another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_sketch_tpu as jts
import tt_sketch_torch
from tt_sketch_torch import config
from tt_sketch_torch.drm import (
    SparseGaussianDRM,
    SparseSignDRM,
    TensorTrainDRM,
)
from tt_sketch_torch.engine import dispatch as D
from tt_sketch_torch.engine.dispatch import (
    SketchMethod,
    general_sketch,
    orth_step,
)
from tt_sketch_torch.engine.sketch import (
    hmt_sketch,
    orthogonal_sketch,
    stream_sketch,
)
from tt_sketch_torch.formats import DenseTensor, SparseTensor, TensorTrain
from tt_sketch_torch.interop import tt_drm_from_numpy
from tt_sketch_torch.kernels import sketch_kernels as K
from tt_sketch_torch.kernels.sparse_plan import ModePlan, WindowPlan
from tt_sketch_tpu.drm import SparseGaussianDRM as JSG
from tt_sketch_tpu.drm import SparseSignDRM as JSS
from tt_sketch_tpu.drm import TensorTrainDRM as JTT
from tt_sketch_tpu.engine.dispatch import orth_step as j_orth_step
from tt_sketch_tpu.engine.sketch import hmt_sketch as j_hmt
from tt_sketch_tpu.engine.sketch import orthogonal_sketch as j_otts
from tt_sketch_tpu.formats import SparseTensor as JST

SHAPE = (11, 9, 30, 25)
NNZ = 1200
DENSE_SHAPE = (8, 5, 6, 7)
RANK, RIGHT_RANK = (4, 4, 4), (8, 8, 8)
DRMS = {"gauss": (SparseGaussianDRM, JSG), "sign": (SparseSignDRM, JSS),
        "tt": (TensorTrainDRM, JTT)}
DTYPES = {"f64": (torch.float64, jnp.float64, np.float64, 1e-10),
          "f32": (torch.float32, jnp.float32, np.float32, 2e-4)}
WRAPPERS = ("psi_fused_slabs", "psi_chunk_slabs_genright", "psi_chunk_slabs",
            "psi_window_direct", "omega_fused", "_psi_sparse_segment")


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


@pytest.fixture
def called(monkeypatch):
    """Counts the calls of every Ψ/Ω kernel wrapper and of the segment
    reduction that ``sketch_kernels`` makes."""
    counts = dict.fromkeys(WRAPPERS, 0)

    def counting(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    for name in WRAPPERS:
        monkeypatch.setattr(K, name, counting(name, getattr(K, name)))
    return counts


def _data(dtype=np.float32, seed=31):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, NNZ) for s in SHAPE]).astype(np.int64)
    ent = rng.standard_normal(NNZ).astype(dtype)
    return idx, ent


def _pair(idx, ent, threshold=12, **plan_kw):
    # threshold 12 plans this shape as FROSTT-uber is planned: modes 0 and 1
    # without a plan, modes 2 and 3 with a ModePlan; 8 plans every mode
    ours, ref = SparseTensor(SHAPE, idx, ent), JST(SHAPE, idx, ent)
    if threshold is not None:
        ours = ours.with_psi_plan(threshold=threshold, chunk=128, **plan_kw)
        ref = ref.with_psi_plan(indices=idx, entries=ent,
                                threshold=threshold, chunk=128, **plan_kw)
    return ours, ref


def _close_dense(tt, jtt, rel):
    a = tt.to_dense().numpy().astype(np.float64)
    b = np.asarray(jtt.to_numpy(), np.float64)
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


def _used(counts):
    return {k: v for k, v in counts.items() if v}


# -- the sparse Ψ/Ω dispatch: which kernel serves which sides ------------------

def _rows(r, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((r, NNZ), generator=g)


def _f32_tensor(**plan_kw):
    idx, ent = _data()
    return _pair(idx, ent, **plan_kw)[0]


def _gauss(rank, transpose, dtype=torch.float32):
    return SparseGaussianDRM(rank, SHAPE, transpose, seed=5, dtype=dtype)


@pytest.mark.parametrize("case,mu,want", [
    ("hash x hash", 2, "psi_fused_slabs"),
    ("none x hash", 0, "_psi_sparse_segment"),      # mode 0 has no plan
    ("array x hash", 2, "psi_chunk_slabs_genright"),
    ("hash x array", 2, "psi_chunk_slabs_genright"),  # the swapped call
    ("hash x none", 3, "psi_fused_slabs"),
    ("array x none", 3, "psi_chunk_slabs"),
    ("array x array", 2, "psi_chunk_slabs"),
    ("thunk x thunk", 2, "psi_chunk_slabs"),
    ("array x hash, no plan", 1, "_psi_sparse_segment"),
])
def test_sketch_psi_sparse_branches(called, case, mu, want):
    """Fused, half-fused (both orientations), grouped and segment: one
    wrapper serves each combination of sides, and Ψ agrees with the segment
    reduction over materialized rows."""
    t = _f32_tensor()
    assert [type(p) for p in t.psi_plan] == [type(None), type(None),
                                             ModePlan, ModePlan]
    d = len(SHAPE)
    ldrm, rdrm = _gauss(5, False), _gauss(7, True)
    lrows = ldrm.sketch_sparse(t)[mu - 1] if mu > 0 else None
    rrows = rdrm.sketch_sparse(t)[mu] if mu < d - 1 else None
    left_kind, right_kind = case.split(",")[0].split(" x ")
    kw = {}
    if left_kind == "hash":
        kw["left_drm"] = ldrm
    if right_kind == "hash":
        kw["right_drm"] = rdrm
    sides = [lrows, rrows]
    if "thunk" in case:
        sides = [lambda: lrows, lambda: rrows]
    got = K.sketch_psi_sparse(*sides, tensor=t, mu=mu, **kw)
    assert _used(called) == {want: 1}
    ref = K._psi_sparse_segment(lrows, rrows, t.entries, t.indices[mu],
                                SHAPE[mu])
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=3e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("case,want", [
    ("hash x hash", "psi_window_direct"),
    ("array x hash", "_psi_sparse_segment"),
    ("array x array", "_psi_sparse_segment"),
])
def test_window_plan_with_a_given_side_takes_the_segment_reduction(
        called, case, want):
    t = _f32_tensor(window_threshold=20, window_span=8)
    assert isinstance(t.psi_plan[2], WindowPlan)
    ldrm, rdrm = _gauss(5, False), _gauss(7, True)
    lrows, rrows = ldrm.sketch_sparse(t)[1], rdrm.sketch_sparse(t)[2]
    kw = {"right_drm": rdrm} if "x hash" in case else {}
    if case.startswith("hash"):
        kw["left_drm"] = ldrm
    got = K.sketch_psi_sparse(lrows, rrows, tensor=t, mu=2, **kw)
    assert _used(called) == {want: 1}
    ref = K._psi_sparse_segment(lrows, rrows, t.entries, t.indices[2],
                                SHAPE[2])
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=3e-5 * float(ref.abs().max()))


def test_float64_with_a_plan_takes_the_segment_reduction(called):
    idx, ent = _data(np.float64)
    t, _ = _pair(idx, ent)
    rdrm = _gauss(7, True, torch.float64)
    lrows = _rows(5).double()
    K.sketch_psi_sparse(lrows, rdrm.sketch_sparse(t)[2], tensor=t, mu=2,
                        right_drm=rdrm)
    K.sketch_omega_sparse(lrows, rdrm.sketch_sparse(t)[2], tensor=t, mu=2,
                          left_drm=_gauss(5, False, torch.float64),
                          right_drm=rdrm)
    assert _used(called) == {"_psi_sparse_segment": 1}


@pytest.mark.parametrize("case,fused", [
    ("hash x hash", True), ("hash x hash, no mu", False),
    ("array x hash", False), ("hash x tt", False),
])
def test_sketch_omega_sparse_branches(called, case, fused):
    t = _f32_tensor()
    ldrm, rdrm = _gauss(5, False), _gauss(7, True)
    if "tt" in case:
        rdrm = TensorTrainDRM(7, SHAPE, True, seed=6, dtype=torch.float32)
    lrows, rrows = ldrm.sketch_sparse(t)[1], rdrm.sketch_sparse(t)[1]
    kw = dict(tensor=t, mu=None if "no mu" in case else 1, right_drm=rdrm)
    if case.startswith("hash"):
        kw["left_drm"] = ldrm
    got = K.sketch_omega_sparse(lambda: lrows, lambda: rrows, **kw)
    assert _used(called) == ({"omega_fused": 1} if fused else {})
    ref = (lrows * t.entries) @ rrows.T
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=3e-5 * float(ref.abs().max()))


def test_fused_paths_never_read_their_sides(called):
    """A fused Ψ or Ω hashes its rows in the kernel: the thunks of a
    ``LazyModeList`` element are not called, so the rows are not made."""
    t = _f32_tensor()
    ldrm, rdrm = _gauss(5, False), _gauss(7, True)

    def boom():
        raise AssertionError("a fused path materialized a side")

    K.sketch_psi_sparse(boom, boom, tensor=t, mu=2, left_drm=ldrm,
                        right_drm=rdrm)
    K.sketch_omega_sparse(boom, boom, tensor=t, mu=1, left_drm=ldrm,
                          right_drm=rdrm)
    # half-fused: only the given side is read
    K.sketch_psi_sparse(lambda: _rows(5), boom, tensor=t, mu=2,
                        right_drm=rdrm)
    assert _used(called) == {"psi_fused_slabs": 1, "omega_fused": 1,
                             "psi_chunk_slabs_genright": 1}


def test_there_is_no_hash_sorted_branch():
    """The JAX package's ``_psi_sparse_hash_sorted`` has the fused branch's
    condition and is tested after it, so nothing reaches it; the port has
    no such branch."""
    assert not hasattr(K, "_psi_sparse_hash_sorted")
    assert not hasattr(K, "_can_hash_sorted_psi")


# -- streaming with a mixed pair (the swapped half-fused orientation) ----------

@pytest.mark.parametrize("pair", ["tt x gauss", "gauss x tt", "tt x tt",
                                  "tt x sign"])
def test_streaming_mixed_pair_matches_jax(pallas_interpret, called, pair):
    """``stream_sketch`` of a planned sparse tensor with a ``TensorTrainDRM``
    on one side and a hash DRM on the other: the planned interior mode takes
    the half-fused kernel (hash left / array right is its swapped
    orientation), the TT-DRM's cores carried over by ``tt_drm_from_numpy``."""
    idx, ent = _data()
    t, jt = _pair(idx, ent)
    left, right = pair.split(" x ")

    def make(kind, rank, transpose, seed):
        if kind == "tt":
            jdrm = JTT(rank, SHAPE, transpose, seed=seed, dtype=jnp.float32)
            return jdrm, tt_drm_from_numpy(
                [np.asarray(c) for c in jdrm.cores], rank, SHAPE, transpose,
                seed=seed)
        ours, theirs = DRMS[kind][:2]
        return (theirs(rank, SHAPE, transpose, seed=seed, dtype=jnp.float32),
                ours(rank, SHAPE, transpose, seed=seed, dtype=torch.float32))

    jl, ldrm = make(left, 4, False, 3)
    jr, rdrm = make(right, 8, True, 4)
    sk = stream_sketch(t, 4, 8, left_drm=ldrm, right_drm=rdrm)
    jsk = jts.stream_sketch(jt, 4, 8, left_drm=jl, right_drm=jr)
    want = {"_psi_sparse_segment": 2}  # the unplanned modes 0 and 1
    if pair == "tt x tt":
        want["psi_chunk_slabs"] = 2
    elif left == "tt":
        want.update(psi_chunk_slabs_genright=1, psi_chunk_slabs=1)
    else:
        want.update(psi_chunk_slabs_genright=1, psi_fused_slabs=1)
    assert _used(called) == want
    for a, b in zip(sk.Psi_cores + sk.Omega_mats,
                    list(jsk.Psi_cores) + list(jsk.Omega_mats)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=3e-5 * np.abs(b).max())


# -- hmt_sketch and orthogonal_sketch on sparse input --------------------------

@pytest.mark.parametrize("drm", ["gauss", "sign", "tt"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("threshold", [8, 12, None],
                         ids=["planned", "uberlike", "unplanned"])
def test_hmt_sketch_sparse_matches_jax(pallas_interpret, drm, dtype,
                                       threshold):
    tdt, jdt, ndt, rel = DTYPES[dtype]
    idx, ent = _data(ndt)
    t, jt = _pair(idx, ent, threshold)
    ours, theirs = DRMS[drm]
    tt = hmt_sketch(t, RANK, seed=9, drm_type=ours, dtype=tdt)
    jtt = j_hmt(jt, RANK, seed=9, drm_type=theirs, dtype=jdt)
    assert isinstance(tt, TensorTrain) and tt.cores[0].dtype == tdt
    assert tt.rank == tuple(jtt.rank)
    _close_dense(tt, jtt, rel)


@pytest.mark.parametrize("drm", ["gauss", "sign", "tt"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("threshold", [12, None],
                         ids=["uberlike", "unplanned"])
def test_orthogonal_sketch_sparse_matches_jax(pallas_interpret, drm, dtype,
                                              threshold):
    tdt, jdt, ndt, rel = DTYPES[dtype]
    idx, ent = _data(ndt)
    t, jt = _pair(idx, ent, threshold)
    ours, theirs = DRMS[drm]
    tt = orthogonal_sketch(t, RANK, RIGHT_RANK, seed=9, left_drm_type=ours,
                           right_drm_type=ours, dtype=tdt)
    jtt = j_otts(jt, RANK, RIGHT_RANK, seed=9, left_drm_type=theirs,
                 right_drm_type=theirs, dtype=jdt)
    assert tt.rank == tuple(jtt.rank)
    _close_dense(tt, jtt, rel)


@pytest.mark.parametrize("method,drm,want", [
    ("hmt", "gauss", {"_psi_sparse_segment": 2, "psi_chunk_slabs_genright": 1,
                      "psi_chunk_slabs": 1}),
    ("hmt", "tt", {"_psi_sparse_segment": 2, "psi_chunk_slabs": 2}),
    ("otts", "gauss", {"_psi_sparse_segment": 2, "omega_fused": 3,
                       "psi_chunk_slabs_genright": 1, "psi_chunk_slabs": 1}),
    ("otts", "sign", {"_psi_sparse_segment": 2, "omega_fused": 3,
                      "psi_chunk_slabs_genright": 1, "psi_chunk_slabs": 1}),
])
def test_sequential_sketch_kernel_calls(called, monkeypatch, method, drm,
                                        want):
    """What one sequential sketch of a tensor planned as FROSTT-uber is
    (modes 0, 1 unplanned, modes 2, 3 ``ModePlan``) calls, chain steps
    included: a hash DRM's sketch runs the chain once, a TT-DRM's twice."""
    from tt_sketch_torch.drm import tensor_train_drm as TD

    steps = []
    wrapper = TD.chain_step_t
    monkeypatch.setattr(TD, "chain_step_t",
                        lambda *a: steps.append(a[0] is None) or wrapper(*a))
    t = _f32_tensor()
    ours = DRMS[drm][0]
    if method == "hmt":
        hmt_sketch(t, RANK, seed=1, drm_type=ours, dtype=torch.float32)
    else:
        orthogonal_sketch(t, RANK, RIGHT_RANK, seed=1, left_drm_type=ours,
                          right_drm_type=ours, dtype=torch.float32)
    assert _used(called) == want
    d = len(SHAPE)
    assert len(steps) == (d - 1) * (2 if drm == "tt" else 1)
    assert sum(steps) == (2 if drm == "tt" else 1)  # first steps: no state


# -- TT and dense input ---------------------------------------------------------

def _dense_pair(fmt, seed=0, rank=3):
    tt = TensorTrain.random(DENSE_SHAPE, rank, seed=seed)
    jtt = jts.TensorTrain.random(DENSE_SHAPE, rank, seed=seed)
    if fmt == "tt":
        return tt, jtt
    return DenseTensor(tt.to_dense()), jts.DenseTensor(jtt.to_dense())


@pytest.mark.parametrize("fmt", ["tt", "dense"])
@pytest.mark.parametrize("rank", [2, 4])
def test_hmt_sketch_tt_and_dense_match_jax(fmt, rank):
    X, jX = _dense_pair(fmt)
    tt = hmt_sketch(X, rank, seed=5)
    jtt = j_hmt(jX, rank, seed=5)
    assert tt.rank == tuple(jtt.rank)
    _close_dense(tt, jtt, 1e-10)
    if rank >= 3:  # at least the tensor's rank: exact recovery
        assert tt.error(X, relative=True) < 1e-9


@pytest.mark.parametrize("fmt", ["tt", "dense"])
@pytest.mark.parametrize("ranks", [(2, 4), (4, 7)])
def test_orthogonal_sketch_tt_and_dense_match_jax(fmt, ranks):
    X, jX = _dense_pair(fmt)
    tt = orthogonal_sketch(X, *ranks, seed=5)
    jtt = j_otts(jX, *ranks, seed=5)
    assert tt.rank == tuple(jtt.rank)
    _close_dense(tt, jtt, 1e-10)
    if ranks[0] >= 3:
        assert tt.error(X, relative=True) < 1e-9


# -- the entry points ----------------------------------------------------------

def test_entry_points_are_exported():
    assert tt_sketch_torch.hmt_sketch is hmt_sketch
    assert tt_sketch_torch.orthogonal_sketch is orthogonal_sketch
    with pytest.raises(AttributeError):
        tt_sketch_torch.hmt_sketch_blocked


def test_hmt_default_drm_return_drm_and_given_drm():
    X, _ = _dense_pair("dense")
    tt, drm = hmt_sketch(X, 4, seed=2, return_drm=True)
    assert isinstance(drm, TensorTrainDRM) and drm.transpose
    again = hmt_sketch(X, 4, drm=drm)
    np.testing.assert_allclose(again.to_dense().numpy(),
                               tt.to_dense().numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="does not match"):
        hmt_sketch(X, 3, drm=drm)
    # compile= is the JAX package's switch; torch runs eagerly either way
    compiled = hmt_sketch(X, 4, seed=2, compile=True)
    assert torch.equal(compiled.to_dense(), tt.to_dense())


def test_stream_sketch_takes_compile_as_the_jax_package_does():
    # the arguments of round_tt_sum's sketch in
    # tt_sketch_tpu/solvers/tt_gmres.py, on a TT
    from math import ceil

    from tt_sketch_torch.utils import process_tt_rank

    X, jX = _dense_pair("tt", rank=4)
    left_rank = process_tt_rank(3, X.shape, trim=True)
    right_rank = tuple(ceil(r * 2.0) for r in left_rank)
    kw = dict(left_rank=left_rank, right_rank=right_rank, seed=4,
              dtype=torch.float64)
    compiled = stream_sketch(X, compile=True, **kw)
    eager = stream_sketch(X, **kw)
    for a, b in zip(compiled.Psi_cores + compiled.Omega_mats,
                    eager.Psi_cores + eager.Omega_mats):
        assert torch.equal(a, b)
    jsk = jts.stream_sketch(jX, left_rank=left_rank, right_rank=right_rank,
                            seed=4, dtype=jnp.float64, compile=True)
    _close_dense(compiled.to_tt(), jsk.to_tt(), 1e-10)


def test_orthogonal_return_drm_given_drms_and_rank_check():
    X, _ = _dense_pair("tt")
    tt, ldrm, rdrm = orthogonal_sketch(X, 3, 6, seed=2, return_drm=True)
    assert not ldrm.transpose and rdrm.transpose
    again = orthogonal_sketch(X, 3, 6, left_drm=ldrm, right_drm=rdrm,
                              compile=True)
    np.testing.assert_allclose(again.to_dense().numpy(),
                               tt.to_dense().numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="larger than the left rank"):
        orthogonal_sketch(X, 6, 6, seed=2)
    with pytest.raises(ValueError, match="Left rank"):
        orthogonal_sketch(X, 2, 6, left_drm=ldrm, right_drm=rdrm)
    with pytest.raises(ValueError, match="Right rank"):
        orthogonal_sketch(X, 3, 7, left_drm=ldrm, right_drm=rdrm)


def test_general_sketch_needs_a_left_drm_except_for_hmt():
    X, _ = _dense_pair("dense")
    _, ldrm, rdrm = orthogonal_sketch(X, 3, 6, seed=2, return_drm=True)
    for method in (SketchMethod.streaming, SketchMethod.orthogonal):
        with pytest.raises(ValueError, match="left_drm must be provided"):
            general_sketch(X, None, rdrm, method)
    sk = general_sketch(X, None, rdrm, SketchMethod.hmt)
    assert sk.Omega_mats == [] and len(sk.Psi_cores) == len(DENSE_SHAPE)
    with pytest.raises(ValueError, match="dtype"):
        general_sketch(DenseTensor(X.data.float()), None, rdrm,
                       SketchMethod.hmt)


@pytest.mark.parametrize("with_omega", [False, True], ids=["hmt", "otts"])
def test_orth_step_spans_what_jax_spans(with_omega):
    """The orthogonalized core has orthonormal columns and the column space
    of the JAX package's (the columns themselves may differ in sign)."""
    rng = np.random.default_rng(4)
    psi = rng.standard_normal((3, 6, 7))
    omega = rng.standard_normal((4, 7)) if with_omega else None
    got = orth_step(torch.from_numpy(psi),
                    None if omega is None else torch.from_numpy(omega))
    ref = np.asarray(j_orth_step(
        jnp.asarray(psi), None if omega is None else jnp.asarray(omega)))
    assert tuple(got.shape) == ref.shape == (3, 6, 4 if with_omega else 7)
    q, qr = got.numpy().reshape(18, -1), ref.reshape(18, -1)
    np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=1e-12)
    np.testing.assert_allclose(q @ q.T, qr @ qr.T, atol=1e-10)


def test_chains_of_unported_formats_raise():
    """A tensor of a type the dispatch does not know raises, it is not
    sketched as something else; CP, Tucker and ``TensorSum`` chains exist
    now (a sum keeps one child chain per summand)."""
    class Unknown:
        shape = DENSE_SHAPE

    with pytest.raises(ValueError, match="Cannot chain-sketch"):
        D._OrthogChain(Unknown())
    for fmt in (SparseTensor, TensorTrain, DenseTensor, D.CPTensor,
                D.TuckerTensor):
        assert fmt in D.DRM_SKETCH_METHOD_DISPATCH
    assert D.TensorSum not in D.DRM_SKETCH_METHOD_DISPATCH
    tt = TensorTrain.random(DENSE_SHAPE, 2, seed=0)
    chain = D._OrthogChain(tt + tt * 2.0)
    assert [type(c.tensor) for c in chain.children] == [TensorTrain] * 2
