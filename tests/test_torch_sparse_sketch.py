"""The sparse STTA slice of the port against the JAX package: formats,
``SparseGaussianDRM``, ``stream_sketch`` on sparse input, the FROSTT
loader, and the gate between kernels and plain versions.

Reference side: the JAX package's fused sparse path with the Pallas
kernels in interpret mode (``TT_SKETCH_TPU_FORCE_TPU=1``,
``TT_SKETCH_TPU_PALLAS_INTERPRET=1``) for float32, its parity path for
float64.  Tolerances, with their reasons:

- float32 Ψ/Ω: ``3e-5·max|ref|`` (float32 sums in another order, as
  ``tests/test_sparse_plan.py`` holds fused against plain);
- float32 entries of ``to_tt()``: ``1e-3·max|ref|`` (the Ψ/Ω differences
  pass through the pseudo-inverse of Ω, whose condition number at these
  ranks is at most a few tens);
- float64: 1e-10 (the same rows, summed in another order);
- exact recovery of a TT-structured sparse tensor: 1e-9 relative error.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_sketch_tpu as jts
from tt_sketch_torch import config
from tt_sketch_torch.data.frostt import FROSTT_TENSORS, load_frostt, sample_error
from tt_sketch_torch.drm import SparseGaussianDRM, TensorTrainDRM
from tt_sketch_torch.engine.sketch import stream_sketch
from tt_sketch_torch.formats import SparseTensor, TensorTrain
from tt_sketch_torch.interop import sparse_tensor_from_numpy
from tt_sketch_torch.kernels import lazy_gaussian as LG
from tt_sketch_torch.kernels import sparse_psi as SP
from tt_sketch_tpu.data.frostt import sample_error as j_sample_error
from tt_sketch_tpu.drm import SparseGaussianDRM as JSG
from tt_sketch_tpu.formats import SparseTensor as JST

SHAPE = (11, 9, 30, 25)
NNZ = 2500


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


def _data(dtype=np.float32, seed=6):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, NNZ) for s in SHAPE]).astype(np.int64)
    ent = rng.standard_normal(NNZ).astype(dtype)
    return idx, ent


def _pair(idx, ent, threshold=None):
    ours = SparseTensor(SHAPE, idx, ent)
    ref = JST(SHAPE, idx, ent)
    if threshold is not None:
        ours = ours.with_psi_plan(threshold=threshold, chunk=128)
        ref = ref.with_psi_plan(indices=idx, entries=ent,
                                threshold=threshold, chunk=128)
    return ours, ref


def _close(ours, ref, rel):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=rel * np.abs(b).max())


def _sketches(t, jt, dtype, jdtype, seed=7, ranks=(4, 8)):
    kw = dict(left_rank=ranks[0], right_rank=ranks[1], seed=seed)
    sk = stream_sketch(t, left_drm_type=SparseGaussianDRM,
                       right_drm_type=SparseGaussianDRM, dtype=dtype, **kw)
    jsk = jts.stream_sketch(jt, left_drm_type=JSG, right_drm_type=JSG,
                            dtype=jdtype, **kw)
    return sk, jsk


# -- format --------------------------------------------------------------------

def test_sparse_tensor_matches_jax():
    idx, ent = _data(np.float64)
    t, jt = _pair(idx, ent)
    assert t.nnz == jt.nnz == NNZ and t.size == jt.size
    np.testing.assert_allclose(t.to_dense().numpy(), np.asarray(jt.to_dense()),
                               atol=1e-14)
    assert t.norm() == pytest.approx(jt.norm(), rel=1e-14)
    q = np.concatenate([idx[:, :50], np.zeros((4, 3), np.int64)], axis=1)
    np.testing.assert_allclose(t.gather(q).numpy(),
                               np.asarray(jt.gather(jnp.asarray(q))),
                               atol=1e-14)
    tt = t.T
    assert tt.shape == SHAPE[::-1]
    np.testing.assert_array_equal(tt.indices.numpy(), idx[::-1])
    np.testing.assert_allclose((t * 3.0).entries.numpy(), 3 * ent)
    assert t.astype(torch.float32).entries.dtype == torch.float32
    r = SparseTensor.random(SHAPE, 300, seed=4)
    jr = JST.random(SHAPE, 300, seed=4)
    np.testing.assert_array_equal(r.indices.numpy(), np.asarray(jr.indices))
    np.testing.assert_array_equal(r.entries.numpy(), np.asarray(jr.entries))


def test_plan_follows_scaling_and_casts():
    idx, ent = _data(np.float64)
    t = SparseTensor(SHAPE, idx, ent).with_psi_plan(threshold=8)
    for orig, s, c in zip(t.psi_plan, (t * 3.0).psi_plan,
                          t.astype(torch.float32).psi_plan):
        if orig is None:
            continue
        np.testing.assert_allclose(s.sorted_entries.numpy(),
                                   3 * orig.sorted_entries.numpy())
        assert c.sorted_entries.dtype == torch.float32
    # the transposed plan swaps prefix and suffix streams
    p, q = t.psi_plan[2], t.T.psi_plan[1]
    assert q.flat_left is p.flat_right and q.flat_right is p.flat_left
    assert q.flat_left_om is None


def test_tt_gather_matches_jax():
    tt = TensorTrain.random(SHAPE, 3, seed=2)
    jtt = jts.TensorTrain.random(SHAPE, 3, seed=2)
    idx, _ = _data()
    np.testing.assert_allclose(tt.gather(torch.from_numpy(idx)).numpy(),
                               np.asarray(jtt.gather(idx)), atol=1e-13)


# -- the slice, float32 through the kernels' plain versions ---------------------

@pytest.mark.parametrize("threshold", [12, 8, None])
def test_stream_sketch_f32_matches_pallas(pallas_interpret, threshold):
    # threshold 12: modes 0 and 1 unplanned, so the rows, Ω, merged and
    # no-right Ψ kernels all run; 8: every mode merged or fused; None: no
    # plan (rows and Ω only)
    idx, ent = _data()
    t, jt = _pair(idx, ent, threshold)
    sk, jsk = _sketches(t, jt, torch.float32, jnp.float32)
    _close(sk.Psi_cores, jsk.Psi_cores, 3e-5)
    _close(sk.Omega_mats, jsk.Omega_mats, 3e-5)
    if threshold == 12:
        q = idx[:, :40]
        ref = np.asarray(jsk.to_tt().gather(q))
        np.testing.assert_allclose(
            sk.to_tt().gather(torch.from_numpy(q)).numpy(), ref, rtol=0,
            atol=1e-3 * np.abs(ref).max())


def test_fused_path_takes_every_kernel_plain_version(monkeypatch):
    # on CPU tensors the wrappers run their plain versions: count calls
    idx, ent = _data()
    t = SparseTensor(SHAPE, idx, ent).with_psi_plan(threshold=12, chunk=128)
    calls = {}
    for mod, name in [(LG, "lazy_gaussian_reference"),
                      (SP, "omega_fused_reference"),
                      (SP, "psi_fused_slabs_reference"),
                      (SP, "psi_omega_merged_slabs_reference")]:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    before = {f: f.launches for f in (LG.lazy_gaussian, SP.omega_fused,
                                      SP.psi_fused_slabs,
                                      SP.psi_omega_merged_slabs)}
    stream_sketch(t, 4, 8, seed=1, left_drm_type=SparseGaussianDRM,
                  right_drm_type=SparseGaussianDRM, dtype=torch.float32)
    # 3 row blocks; 2 Ω; merged Ψ_2+Ω_2 (whose Ω part is one more Ω call
    # and whose slabs one more slab call); Ψ_3 without a right side
    assert calls == {"lazy_gaussian_reference": 3,
                     "omega_fused_reference": 3,
                     "psi_fused_slabs_reference": 2,
                     "psi_omega_merged_slabs_reference": 1}
    # a CPU sketch launches no kernel
    assert all(f.launches == n for f, n in before.items())


def test_f32_gate_is_dtype_only(pallas_interpret, monkeypatch):
    # deliberate divergence: float32 rows follow the kernel contract on
    # every device, while the JAX package's CPU backend (no forced TPU)
    # rounds its float64 parity rows to float32
    idx, ent = _data()
    t = SparseTensor(SHAPE, idx, ent)
    jt = JST(SHAPE, idx, ent)
    ours = SparseGaussianDRM(6, SHAPE, transpose=False, seed=3,
                             dtype=torch.float32).sketch_sparse(t)[1]
    kernel = JSG(6, SHAPE, transpose=False, seed=3,
                 dtype=jnp.float32).sketch_sparse(jt)[1]
    np.testing.assert_allclose(ours.numpy(), np.asarray(kernel), rtol=0,
                               atol=2e-6)
    monkeypatch.setenv("TT_SKETCH_TPU_FORCE_TPU", "0")
    parity = np.asarray(JSG(6, SHAPE, transpose=False, seed=3,
                            dtype=jnp.float32).sketch_sparse(jt)[1])
    assert np.abs(ours.numpy() - parity).max() > 1e-7


# -- float64 parity path ---------------------------------------------------------

@pytest.mark.parametrize("threshold", [None, 8])
def test_stream_sketch_f64_matches_jax(threshold):
    idx, ent = _data(np.float64)
    t, jt = _pair(idx, ent, threshold)
    sk, jsk = _sketches(t, jt, torch.float64, jnp.float64)
    for a, b in zip(sk.Psi_cores + sk.Omega_mats,
                    jsk.Psi_cores + jsk.Omega_mats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)
    d = len(SHAPE)
    assert sk.left_drm.seed == jsk.left_drm.seed
    assert sk.right_drm.seed == jsk.right_drm.seed
    assert len(sk.Psi_cores) == d


@pytest.mark.parametrize("n_mu, r1, r2", [(24, 4, 8), (183, None, 8),
                                          (4096, 4, None), (5000, 3, 5)])
def test_segment_reduction_is_index_add_and_matches_segment_sum(
        monkeypatch, n_mu, r1, r2):
    # off a TPU the JAX package sums with jax.ops.segment_sum for every
    # mode size; the port's counterpart is index_add_, never a one-hot
    # product (modes of at most 4096 rows included)
    from tt_sketch_torch.kernels import sketch_kernels as K
    from tt_sketch_tpu.kernels import sketch_kernels as JK

    rng = np.random.default_rng(11)
    nnz = 3001
    left = None if r1 is None else rng.standard_normal((r1, nnz))
    right = None if r2 is None else rng.standard_normal((r2, nnz))
    ent = rng.standard_normal(nnz)
    idx = rng.integers(0, n_mu, nnz)
    adds = []
    index_add_ = torch.Tensor.index_add_

    def counted(self, *args, **kwargs):
        adds.append(self.shape)
        return index_add_(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "index_add_", counted)
    as_t = (lambda a: None if a is None else torch.from_numpy(a))
    psi = K._psi_sparse_segment(as_t(left), as_t(right), torch.from_numpy(ent),
                                torch.from_numpy(idx), n_mu)
    as_j = (lambda a: None if a is None else jnp.asarray(a))
    ref = np.asarray(JK._psi_sparse_segment(as_j(left), as_j(right),
                                            jnp.asarray(ent),
                                            jnp.asarray(idx), n_mu))
    assert len(adds) == 1 and not JK._use_onehot_segments(n_mu)
    assert tuple(psi.shape) == ref.shape == (r1 or 1, n_mu, r2 or 1)
    np.testing.assert_allclose(psi.numpy(), ref, rtol=0, atol=1e-10)


def test_exact_recovery_of_tt_on_a_subgrid():
    # a sparse tensor whose support is a Cartesian subgrid of a rank-3 TT
    # is itself a TT of rank 3: a rank 4/8 sketch recovers it exactly
    shape = (10, 8, 9, 7)
    rng = np.random.default_rng(0)
    subsets = [np.sort(rng.choice(n, size=s, replace=False))
               for n, s in zip(shape, (6, 5, 6, 5))]
    mesh = np.meshgrid(*subsets, indexing="ij")
    idx = np.stack([m.reshape(-1) for m in mesh])
    tt = TensorTrain.random(shape, 3, seed=1)
    vals = tt.gather(torch.from_numpy(idx))
    t = SparseTensor(shape, torch.from_numpy(idx), vals)
    sk = stream_sketch(t, 4, 8, seed=2, left_drm_type=SparseGaussianDRM)
    dense = t.to_dense()
    err = float(torch.linalg.norm(sk.to_tt().to_dense() - dense)
                / torch.linalg.norm(dense))
    assert err < 1e-9


# -- dispatch, gate and loader -------------------------------------------------

def test_default_drm_is_tt_drm_and_raises_on_sparse():
    # the default TensorTrainDRM no longer raises on sparse input (its
    # ``sketch_sparse`` is the sparse chain): the streaming sketch matches
    # the JAX package's, whose default is the same DRM from the same seeds
    idx, ent = _data(np.float64)
    t, jt = _pair(idx, ent)
    sk, ldrm, rdrm = stream_sketch(t, 4, 8, seed=0, return_drm=True)
    jsk = jts.stream_sketch(jt, 4, 8, seed=0)
    assert isinstance(ldrm, TensorTrainDRM) and isinstance(rdrm, TensorTrainDRM)
    _close(sk.Psi_cores, jsk.Psi_cores, 1e-10)
    _close(sk.Omega_mats, jsk.Omega_mats, 1e-10)
    _close(sk.to_tt().cores, jsk.to_tt().cores, 1e-8)
    rows = TensorTrainDRM(4, SHAPE, transpose=False, seed=0).sketch_sparse(t)
    assert [tuple(r.shape) for r in rows] == [(4, NNZ)] * 3


def test_placement_mismatch_raises():
    idx, ent = _data()
    t = SparseTensor(SHAPE, idx, ent)  # float32 entries
    with pytest.raises(ValueError, match="dtype"):
        stream_sketch(t, 4, 8, seed=0, left_drm_type=SparseGaussianDRM,
                      dtype=torch.float64)


def test_no_card_means_an_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.set_default_device("cuda")
    idx, ent = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        SparseTensor(SHAPE, idx, ent)
    with pytest.raises(RuntimeError, match="CUDA"):
        sparse_tensor_from_numpy(SHAPE, idx, ent)
    with pytest.raises(RuntimeError, match="CUDA"):
        SparseGaussianDRM(4, SHAPE, transpose=False, seed=0,
                          dtype=torch.float32)
    t = SparseTensor(SHAPE, idx, ent, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_sketch(t, 4, 8, seed=0, left_drm_type=SparseGaussianDRM,
                      dtype=torch.float32)


def test_frostt_registry_and_missing_file(tmp_path, monkeypatch):
    from tt_sketch_torch.data import frostt
    from tt_sketch_tpu.data import frostt as jfrostt

    # the registry is the JAX package's: four real tensors, three stand-ins
    assert {n: (i.url, i.nnz, i.shape) for n, i in FROSTT_TENSORS.items()} \
        == {n: (i.url, i.nnz, i.shape)
            for n, i in jfrostt.FROSTT_TENSORS.items()}
    assert FROSTT_TENSORS["uber-synthetic"].shape == (183, 24, 1140, 1717)
    # a missing stand-in is synthesized and cached (a small one here)
    for mod in (frostt, jfrostt):
        monkeypatch.setitem(mod.FROSTT_TENSORS, "uber-synthetic",
                            mod.FrosttInfo("uber-synthetic", "synthetic://uber",
                                           NNZ, SHAPE))
    t = load_frostt("uber-synthetic", cache_dir=tmp_path)
    idx, ent = jfrostt._synthesize(jfrostt.FROSTT_TENSORS["uber-synthetic"])
    np.testing.assert_array_equal(t.indices.numpy(), idx)
    np.testing.assert_array_equal(t.entries.numpy(), ent)
    assert (tmp_path / "uber-synthetic.npz").is_file()
    with pytest.raises(KeyError):
        load_frostt("uber-pickups")


def test_load_frostt_and_sample_error_match_jax(tmp_path):
    # a small stand-in file in the committed layout
    idx, ent = _data(np.float64)
    np.savez(tmp_path / "uber-synthetic.npz", indices=idx, entries=ent,
             shape=np.asarray(SHAPE), synth_version=np.asarray(2))
    t = load_frostt("uber-synthetic", cache_dir=tmp_path, psi_plan=True,
                    plan_kwargs={"threshold": 8})
    assert t.shape == SHAPE and t.nnz == NNZ
    assert [p is not None for p in t.psi_plan] == [True] * 4
    tt = TensorTrain.random(SHAPE, 3, seed=5)
    jtt = jts.TensorTrain.random(SHAPE, 3, seed=5)
    jt = JST(SHAPE, idx, ent)
    assert sample_error(tt, t, n_samples=500) == pytest.approx(
        j_sample_error(jtt, jt, n_samples=500), rel=1e-12)
