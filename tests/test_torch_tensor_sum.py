"""``TensorSum``, ``Tensor.__add__`` and ``SparseTensor.split`` of the port,
and the sketches of sums, against the JAX package.

Reference side: the JAX package on the same numpy data and seeds; float32
sparse sums run its Pallas kernels in interpret mode
(``TT_SKETCH_TPU_FORCE_TPU=1``, ``TT_SKETCH_TPU_PALLAS_INTERPRET=1``).
Tolerances, with their reasons:

- float64 algebra and einsum paths: 1e-12 (the same products, summed in
  another order at most);
- float64 sketches of a split sum against the whole tensor's: 1e-12 (the
  same rows, the per-shard sums added in another order);
- float32 Ψ/Ω: ``3e-5·max|ref|`` (float32 sums in another order, as
  ``tests/test_torch_sparse_sketch.py`` holds the fused path);
- float32 sequential sketches, recovered dense tensors: ``2e-4·max|ref|``
  (as ``tests/test_torch_sequential.py``: a QR per mode);
- plans: exact (integer arrays and the entries they sort).
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
from tt_sketch_torch.engine import dispatch as D
from tt_sketch_torch.engine.sketch import (
    hmt_sketch,
    orthogonal_sketch,
    stream_sketch,
)
from tt_sketch_torch.formats import (
    CPTensor,
    DenseTensor,
    SparseTensor,
    TensorSum,
    TensorTrain,
)
from tt_sketch_torch.interop import (
    cp_tensor_from_numpy,
    tensor_sum_from_numpy,
)
from tt_sketch_torch.kernels import lazy_gaussian as LG
from tt_sketch_torch.kernels import segment_psi as SG
from tt_sketch_torch.kernels import sparse_psi as SP
from tt_sketch_torch.kernels import sparse_sign as SS
from tt_sketch_torch.kernels.sparse_plan import ModePlan
from tt_sketch_tpu.drm import DenseGaussianDRM as JDG
from tt_sketch_tpu.drm import SparseGaussianDRM as JSG
from tt_sketch_tpu.drm import SparseSignDRM as JSS
from tt_sketch_tpu.drm import TensorTrainDRM as JTT
from tt_sketch_tpu.formats import CPTensor as JCP
from tt_sketch_tpu.formats import DenseTensor as JDense
from tt_sketch_tpu.formats import SparseTensor as JST
from tt_sketch_tpu.formats import TensorSum as JSum
from tt_sketch_tpu.formats import TensorTrain as JTrain

SMALL = (5, 6, 7, 4)
SHAPE = (11, 9, 30, 25)
NNZ = 2500
DRMS = {"gauss": (SparseGaussianDRM, JSG), "sign": (SparseSignDRM, JSS),
        "tt": (TensorTrainDRM, JTT), "dense": (DenseGaussianDRM, JDG)}


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


def _data(dtype=np.float32, seed=6, shape=SHAPE, nnz=NNZ):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape]).astype(np.int64)
    ent = rng.standard_normal(nnz).astype(dtype)
    return idx, ent


def _close(ours, ref, rel):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=rel * max(np.abs(b).max(), 1e-300))


def _make(fmt, seed=0):
    """A port tensor and the JAX package's equal one, on SMALL."""
    if fmt == "tt":
        return (TensorTrain.random(SMALL, 2, seed=seed),
                JTrain.random(SMALL, 2, seed=seed))
    if fmt == "dense":
        return (DenseTensor.random(SMALL, seed=seed),
                JDense.random(SMALL, seed=seed))
    if fmt == "sparse":
        return (SparseTensor.random(SMALL, 30, seed=seed),
                JST.random(SMALL, 30, seed=seed))
    if fmt == "cp":
        return CPTensor.random(SMALL, 3, seed=seed), JCP.random(SMALL, 3,
                                                                seed=seed)
    a, ja = _make("tt", seed)
    b, jb = _make("sparse", seed + 1)
    return a + b, ja + jb


# -- algebra -------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["tt", "dense", "sparse", "cp", "sum"])
def test_arithmetic_builds_sums_as_jax_does(fmt):
    """The counterpart of ``tests/test_formats.py::test_arithmetic``."""
    X, JX = _make(fmt)
    Y, JY = _make(fmt, seed=5)
    for ours, ref in ((X * 2.5, JX * 2.5), (X / 2, JX / 2), (X + Y, JX + JY),
                      (X - Y, JX - JY), (-X, -JX)):
        np.testing.assert_allclose(ours.to_dense().numpy(),
                                   np.asarray(ref.to_dense()), atol=1e-12)
    S, JS = X + Y, JX + JY
    assert isinstance(S, TensorSum) and isinstance(JS, JSum)
    assert S.num_summands == JS.num_summands
    assert S.size == JS.size and S.shape == JS.shape
    assert repr(S) == repr(JS)
    assert S.dot(Y) == pytest.approx(JS.dot(JY), abs=1e-12)
    assert Y.dot(S) == pytest.approx(JY.dot(JS), abs=1e-12)
    assert S.norm() == pytest.approx(JS.norm(), abs=1e-12)
    np.testing.assert_allclose(S.T.to_dense().numpy(),
                               np.asarray(JS.T.to_dense()), atol=1e-12)
    assert S.T.shape == SMALL[::-1]


def test_tensor_sum_coefficients():
    """The counterpart of ``tests/test_formats.py::
    test_tensor_sum_coefficients``: one coefficient per summand, and a
    ``ValueError`` for a wrong count."""
    S, JS = _make("sum")
    np.testing.assert_allclose((S * [2.0, -1.0]).to_dense().numpy(),
                               np.asarray((JS * [2.0, -1.0]).to_dense()),
                               atol=1e-12)
    np.testing.assert_allclose((S * np.array([0.5, 3.0])).to_dense().numpy(),
                               np.asarray((JS * [0.5, 3.0]).to_dense()),
                               atol=1e-12)
    for bad in ([1.0, 2.0, 3.0], [1.0]):
        with pytest.raises(ValueError, match="coefficients"):
            S * bad
        with pytest.raises(ValueError, match="coefficients"):
            JS * bad


def test_iadd_and_sum_of_sums():
    a, ja = _make("tt")
    b, jb = _make("cp", seed=2)
    s, js = a + b, ja + jb
    s2, js2 = s + s, js + js
    assert s2.num_summands == js2.num_summands == 4
    s += b
    js += jb
    assert s.num_summands == js.num_summands == 3
    s += a + b
    js += ja + jb
    assert s.num_summands == js.num_summands == 5
    np.testing.assert_allclose(s.to_dense().numpy(),
                               np.asarray(js.to_dense()), atol=1e-12)
    # a tensor plus a sum puts the tensor first
    t = a + (b + b)
    assert [type(x) for x in t.tensors] == [TensorTrain, CPTensor, CPTensor]


def test_summands_share_device_and_dtype():
    """Divergence: the port's sum has ``device`` and ``dtype``, which the
    placement check reads; summands that differ raise there, as a tensor
    and DRMs that differ do."""
    a = TensorTrain.random(SMALL, 2, seed=0)
    s = a + a
    assert s.device == torch.device("cpu") and s.dtype == torch.float64
    mixed = a + TensorTrain.random(SMALL, 2, seed=1, dtype=torch.float32)
    with pytest.raises(ValueError, match="differ in dtype"):
        mixed.dtype
    with pytest.raises(ValueError, match="differ in dtype"):
        stream_sketch(mixed, 3, 5, seed=0)
    ldrm = TensorTrainDRM(3, SMALL, False, seed=0, dtype=torch.float32)
    rdrm = TensorTrainDRM(5, SMALL, True, seed=1, dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        stream_sketch(s, 3, 5, left_drm=ldrm, right_drm=rdrm)


def test_tensor_sum_from_numpy_carries_jax_summands():
    jtt = JTrain.random(SMALL, 2, seed=3)
    jcp = JCP.random(SMALL, 2, seed=4)
    jsp = JST.random(SMALL, 20, seed=5)
    port_cp = cp_tensor_from_numpy([np.asarray(c) for c in jcp.cores])
    s = tensor_sum_from_numpy([
        ("tt", [np.asarray(c) for c in jtt.cores]), port_cp,
        ("sparse", SMALL, np.asarray(jsp.indices), np.asarray(jsp.entries)),
        ("dense", np.asarray(jtt.to_dense())),
    ])
    assert s.tensors[1] is port_cp
    ref = jtt + jcp + jsp + JDense(jtt.to_dense())
    np.testing.assert_allclose(s.to_dense().numpy(),
                               np.asarray(ref.to_dense()), atol=1e-12)
    with pytest.raises(ValueError, match="unknown summand format"):
        tensor_sum_from_numpy([("mps", [])])


# -- split ---------------------------------------------------------------------

@pytest.mark.parametrize("n_summands", [1, 3, 4, 7])
def test_sparse_split_linearity(n_summands):
    """The counterpart of ``tests/test_formats.py::
    test_sparse_split_linearity``: contiguous shards of nnz, the last one
    taking the remainder, the same as the JAX package's."""
    X = SparseTensor.random(SMALL, 33, seed=0)
    JX = JST.random(SMALL, 33, seed=0)
    S, JS = X.split(n_summands), JX.split(n_summands)
    assert S.num_summands == JS.num_summands == n_summands
    for a, b in zip(S.tensors, JS.tensors):
        np.testing.assert_array_equal(a.indices.numpy(),
                                      np.asarray(b.indices))
        np.testing.assert_array_equal(a.entries.numpy(),
                                      np.asarray(b.entries))
    np.testing.assert_allclose(S.to_dense().numpy(), X.to_dense().numpy(),
                               atol=1e-14)


@pytest.mark.parametrize("plan_kw", [dict(threshold=12, chunk=128),
                                     dict(threshold=8, chunk=64),
                                     dict(threshold=8, window_threshold=20)])
def test_split_plans_equal_jax_plans_of_each_shard(plan_kw):
    idx, ent = _data()
    S = SparseTensor(SHAPE, idx, ent).split(3, psi_plan=True, **plan_kw)
    JS = JST(SHAPE, idx, ent).split(3, psi_plan=True, **plan_kw)
    for shard, jshard in zip(S.tensors, JS.tensors):
        assert shard.psi_plan is not None
        for p, q in zip(shard.psi_plan, jshard.psi_plan):
            assert (p is None) == (q is None)
            if p is None:
                continue
            assert type(p).__name__ == type(q).__name__
            assert (p.n_chunks, p.span, p.chunk) == (q.n_chunks, q.span,
                                                     q.chunk)
            for name in ("perm", "local_idx", "slot_rows", "sorted_entries",
                         "gather_slots", "chunk_window", "chunk_first"):
                a, b = getattr(p, name, None), getattr(q, name, None)
                assert (a is None) == (b is None), name
                if a is not None:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                                  name)
            for name in ("flat_left", "flat_right", "flat_left_om"):
                a, b = getattr(p, name), getattr(q, name)
                assert (a is None) == (b is None), name
                if a is not None:
                    hi, lo = (np.asarray(x).astype(np.uint64) for x in b)
                    np.testing.assert_array_equal(
                        a.numpy().view(np.uint64),
                        (hi << np.uint64(32)) | lo, name)


# -- sketches of sums ----------------------------------------------------------

def test_sparse_split_sketch_equality():
    """The counterpart of ``tests/test_sketching.py::
    test_sparse_split_sketch_equality`` (float64, every DRM that sketches
    sparse input): the split sum's sketch is the whole tensor's."""
    idx, ent = _data(np.float64, shape=SMALL, nnz=50)
    X = SparseTensor(SMALL, idx, ent)
    for name, (drm, _) in DRMS.items():
        s1, ldrm, rdrm = stream_sketch(X, 4, 7, seed=11, return_drm=True,
                                       left_drm_type=drm,
                                       right_drm_type=drm)
        s2 = stream_sketch(X.split(3), 4, 7, left_drm=ldrm, right_drm=rdrm)
        for a, b in zip(s1.Psi_cores + s1.Omega_mats,
                        s2.Psi_cores + s2.Omega_mats):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12,
                                       err_msg=name)


@pytest.mark.parametrize("drm", ["tt", "dense"])
def test_sketch_linearity_matches_jax(drm):
    """``tests/test_sketching.py::test_sketch_linearity``: sketch(A + B) is
    sketch(A) + sketch(B) with the same DRMs, and equals the JAX
    package's."""
    A, JA = _make("tt", 0)
    B, JB = _make("tt", 1)
    dt, jdt = DRMS[drm]
    s, ldrm, rdrm = stream_sketch(A + B, 5, 9, seed=5, return_drm=True,
                                  left_drm_type=dt, right_drm_type=dt)
    js = jts.stream_sketch(JA + JB, 5, 9, seed=5, left_drm_type=jdt,
                           right_drm_type=jdt)
    sa = stream_sketch(A, 5, 9, left_drm=ldrm, right_drm=rdrm)
    sb = stream_sketch(B, 5, 9, left_drm=ldrm, right_drm=rdrm)
    both = sa.sketch_ + sb.sketch_
    _close(s.Psi_cores + s.Omega_mats, both.Psi_cores + both.Omega_mats,
           1e-12)
    _close(s.Psi_cores + s.Omega_mats, js.Psi_cores + js.Omega_mats, 1e-12)


@pytest.mark.parametrize("method", ["stream", "orth", "hmt"])
def test_mixed_format_sum_matches_jax(method):
    """``tests/test_sketching.py::test_tensor_sum_of_mixed_formats``: TT +
    sparse + CP through the three methods with the default DRMs, against
    the JAX package (float64)."""
    tt, jtt = _make("tt", 0)
    sp, jsp = _make("sparse", 1)
    cp, jcp = _make("cp", 2)
    total, jtotal = tt + sp * 1e-3 + cp, jtt + jsp * 1e-3 + jcp
    if method == "stream":
        ours = stream_sketch(total, 8, 14, seed=5)
        ref = jts.stream_sketch(jtotal, 8, 14, seed=5)
        _close(ours.Psi_cores + ours.Omega_mats,
               ref.Psi_cores + ref.Omega_mats, 1e-12)
        ours, ref = ours.to_tt(), ref.to_tt()
    elif method == "orth":
        ours = orthogonal_sketch(total, 6, 9, seed=5)
        ref = jts.orthogonal_sketch(jtotal, 6, 9, seed=5)
    else:
        ours = hmt_sketch(total, 6, seed=5)
        ref = jts.hmt_sketch(jtotal, 6, seed=5)
    b = np.asarray(ref.to_dense())
    np.testing.assert_allclose(ours.to_dense().numpy(), b, rtol=0,
                               atol=1e-10 * np.abs(b).max())
    err = ours.error(total.to_dense(), relative=True)
    assert err == pytest.approx(
        ref.error(np.asarray(jtotal.to_dense()), relative=True), abs=1e-10)


def _shard_pair(dtype=np.float32, n=3, **plan_kw):
    idx, ent = _data(dtype)
    plan_kw = plan_kw or dict(threshold=12, chunk=128)
    return (SparseTensor(SHAPE, idx, ent).split(n, psi_plan=True, **plan_kw),
            JST(SHAPE, idx, ent).split(n, psi_plan=True, **plan_kw),
            SparseTensor(SHAPE, idx, ent).with_psi_plan(**plan_kw))


@pytest.mark.parametrize("pair", ["gauss", "sign", "sign x gauss"])
def test_f32_split_sum_matches_pallas(pallas_interpret, pair):
    """A float32 sum of three planned shards with a hash-family pair,
    against the JAX package's Pallas kernels in interpret mode, and against
    the whole tensor's fused sketch with the same DRMs."""
    lt, jlt = DRMS[pair.split(" x ")[0]]
    rt, jrt = DRMS[pair.split(" x ")[-1]]
    S, JS, whole = _shard_pair()
    kw = dict(left_rank=4, right_rank=8, seed=7)
    sk, ldrm, rdrm = stream_sketch(S, left_drm_type=lt, right_drm_type=rt,
                                   dtype=torch.float32, return_drm=True,
                                   **kw)
    jsk = jts.stream_sketch(JS, left_drm_type=jlt, right_drm_type=jrt,
                            dtype=jnp.float32, **kw)
    _close(sk.Psi_cores, jsk.Psi_cores, 3e-5)
    _close(sk.Omega_mats, jsk.Omega_mats, 3e-5)
    ref = stream_sketch(whole, 4, 8, left_drm=ldrm, right_drm=rdrm)
    _close(sk.Psi_cores + sk.Omega_mats,
           [p.numpy() for p in ref.Psi_cores + ref.Omega_mats], 3e-5)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of each kernel's plain version (what a wrapper
    runs on a CPU tensor)."""
    counts = {}
    for mod, name in [(LG, "lazy_gaussian_reference"),
                      (SS, "sparse_sign_rows_reference"),
                      (SP, "omega_fused_reference"),
                      (SP, "psi_fused_slabs_reference"),
                      (SP, "psi_omega_merged_slabs_reference"),
                      (SP, "psi_chunk_slabs_reference"),
                      (SP, "psi_chunk_slabs_genright_reference"),
                      (SG, "psi_segment_reference")]:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return counts


@pytest.mark.parametrize("n", [1, 3])
def test_split_sum_takes_the_per_mode_kernels(plain_calls, n):
    """A sum never takes the merged whole-tensor path: per shard, Ω_μ
    through the fused Ω kernel, Ψ of a planned mode through the fused slab
    kernel, Ψ of an unplanned one through the segment reduction over rows
    generated once (threshold 12: modes 2 and 3 planned, as on uber)."""
    S, _, whole = _shard_pair(n=n)
    stream_sketch(S, 4, 8, seed=1, left_drm_type=SparseGaussianDRM,
                  right_drm_type=SparseGaussianDRM, dtype=torch.float32)
    assert plain_calls == {"lazy_gaussian_reference": 3 * n,
                           "omega_fused_reference": 3 * n,
                           "psi_fused_slabs_reference": 2 * n,
                           "psi_segment_reference": 2 * n}
    plain_calls.clear()
    stream_sketch(whole, 4, 8, seed=1, left_drm_type=SparseGaussianDRM,
                  right_drm_type=SparseGaussianDRM, dtype=torch.float32)
    assert plain_calls["psi_omega_merged_slabs_reference"] == 1


@pytest.mark.parametrize("drm", ["gauss", "tt"])
def test_hmt_of_split_sum_runs_child_chains(pallas_interpret, plain_calls,
                                            drm):
    """HMT of a float32 sum of three shards: each shard's child chain runs
    the chain step and its Ψ the half-fused or grouped kernel; the result
    equals the JAX package's and the whole tensor's HMT with the same
    DRM (recovered dense tensors, ``2e-4·max|ref|``)."""
    dt, jdt = DRMS[drm]
    S, JS, whole = _shard_pair()
    tt, rdrm = hmt_sketch(S, 5, seed=3, drm_type=dt, dtype=torch.float32,
                          return_drm=True)
    if drm == "gauss":
        # per shard: Ψ_0 segment (rows at step 2), Ψ_1 segment (rows at
        # step 1), Ψ_2 half-fused, Ψ_3 grouped
        assert plain_calls == {"lazy_gaussian_reference": 6,
                               "psi_segment_reference": 6,
                               "psi_chunk_slabs_genright_reference": 3,
                               "psi_chunk_slabs_reference": 3}
    jtt = jts.hmt_sketch(JS, 5, seed=3, drm_type=jdt, dtype=jnp.float32)
    ref = hmt_sketch(whole, 5, drm=rdrm)
    for other in (np.asarray(jtt.to_numpy()), ref.to_dense().numpy()):
        np.testing.assert_allclose(tt.to_dense().numpy(), other, rtol=0,
                                   atol=2e-4 * np.abs(other).max())


def test_otts_of_split_sum_matches_whole(pallas_interpret):
    S, JS, whole = _shard_pair()
    kw = dict(left_drm_type=SparseGaussianDRM,
              right_drm_type=SparseGaussianDRM, dtype=torch.float32)
    tt, ldrm, rdrm = orthogonal_sketch(S, 4, 8, seed=2, return_drm=True,
                                       **kw)
    ref = orthogonal_sketch(whole, 4, 8, left_drm=ldrm, right_drm=rdrm)
    jtt = jts.orthogonal_sketch(JS, 4, 8, seed=2, left_drm_type=JSG,
                                right_drm_type=JSG, dtype=jnp.float32)
    for other in (ref.to_dense().numpy(), np.asarray(jtt.to_numpy())):
        np.testing.assert_allclose(tt.to_dense().numpy(), other, rtol=0,
                                   atol=2e-4 * np.abs(other).max())


def test_sum_sides_are_thunks_for_sparse_summands_only():
    """``_side`` hands a sparse summand a thunk (its fused paths never read
    the rows) and any other summand the array; a ``_PerSummandView`` reads
    a summand's list only when asked."""
    sp = SparseTensor.random(SMALL, 10, seed=0)
    tt = TensorTrain.random(SMALL, 2, seed=0)
    reads = []

    class Rows(list):
        def __getitem__(self, mu):
            reads.append(mu)
            return super().__getitem__(mu)

    view = D._PerSummandView([Rows(["a0", "a1"]), Rows(["b0", "b1"])], 1)
    assert reads == [] and len(view) == 2
    thunk = D._side(view, 0, sp)
    assert callable(thunk) and reads == []
    assert thunk() == "a1" and reads == [1]
    assert D._side(view, 1, tt) == "b1" and reads == [1, 1]
    assert D._side(None, 0, sp) is None
    assert list(view) == ["a1", "b1"]


def test_sum_of_modeplan_shards_keeps_plans_through_scaling():
    S, _, _ = _shard_pair(np.float64)
    scaled = S * [1.0, 2.0, -1.0]
    for a, b, c in zip(S.tensors, scaled.tensors, (1.0, 2.0, -1.0)):
        for p, q in zip(a.psi_plan, b.psi_plan):
            if isinstance(p, ModePlan):
                np.testing.assert_allclose(q.sorted_entries.numpy(),
                                           c * p.sorted_entries.numpy())
