"""The sparse slice's hash, rows, plans and kernel plain versions of the port
against the JAX package.

Reference side: the JAX Pallas kernels in interpret mode on the CPU, fed
the same numpy data; the port runs its plain versions (CPU tensors).
Tolerances, with their reasons:

- hash bits, flat indices, salts and plans: exactly equal (integer code);
- lazy-Gaussian rows, kernel contract: 2e-6 absolute (float32 log/sqrt and
  polynomial rounding of two implementations, a few ulps at |g| <= 5.5);
- parity-path rows (float64 ``ndtri``): 1e-12 absolute;
- Ψ slabs and Ω blocks: ``3e-5·max|ref|`` (float32 sums in another order,
  as ``tests/test_sparse_plan.py`` uses for fused against plain).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_sketch_torch import config
from tt_sketch_torch.interop import mode_plan_from_numpy
from tt_sketch_torch.kernels import lazy_gaussian as LG
from tt_sketch_torch.kernels import sparse_psi as SP
from tt_sketch_torch.kernels.sparse_plan import build_psi_plan
from tt_sketch_torch.rng import hash_rng as H
from tt_sketch_tpu.kernels import pallas_psi as JP
from tt_sketch_tpu.kernels import pallas_rng as JR
from tt_sketch_tpu.kernels.sparse_plan import build_psi_plan as j_build
from tt_sketch_tpu.rng import hash_rng as JH

SHAPE = (11, 9, 30, 25)
NNZ = 2500
#: hash_int_np(30787972) has bits 28..51 all ones: u24 = 2^24 - 1
TOP_QUANTILE_KEY = 30787972
ROWS_TOL = 2e-6


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _i64(a_u64):
    return torch.from_numpy(np.ascontiguousarray(a_u64).view(np.int64))


def _u64(t):
    return t.numpy().view(np.uint64)


def _random_u64(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 63, n, dtype=np.uint64) * np.uint64(2)
    x[: n // 2] += np.uint64(1)
    x[:3] = [0, 2 ** 64 - 1, 2 ** 63]
    return x


# -- hash ----------------------------------------------------------------------

def test_hash_int_bit_exact():
    x = _random_u64(4096, 0)
    assert (_u64(H.hash_int(_i64(x))) == JH.hash_int_np(x)).all()
    # the kernel library's bits-only entry: its plain version on the CPU
    assert (_u64(LG.hash_bits(_i64(x))) == JH.hash_int_np(x)).all()


@pytest.mark.parametrize("shape", [SHAPE, (2 ** 21, 2 ** 21, 2 ** 21, 7)])
def test_flat_index_bit_exact(shape):
    # the second shape's flat indices run past 2^64 and wrap
    rng = np.random.default_rng(1)
    idx = np.stack([rng.integers(0, n, 3000) for n in shape])
    ref = JH._flat_index_np(idx, shape)
    got = _u64(H.flat_index(torch.from_numpy(idx), shape))
    assert (got == ref).all()
    assert (H._flat_index_np(idx, shape) == ref).all()
    if shape != SHAPE:
        assert (ref >= np.uint64(2 ** 63)).any()


def test_drm_salts_bit_exact():
    for rmin, rmax, seed in [(0, 10, 0), (3, 13, 12345), (0, 20, 2 ** 40 + 7)]:
        ref = np.asarray(JR.drm_salts(rmin, rmax, seed)).astype(np.uint64)
        assert (_u64(H.drm_salts(rmin, rmax, seed)) == ref).all()


def test_top_quantile_input_is_finite():
    h = JH.hash_int_np(np.array([TOP_QUANTILE_KEY], np.uint64))
    assert int((h[0] >> np.uint64(28)) & np.uint64(0xFFFFFF)) == 2 ** 24 - 1
    salts = H.drm_salts(0, 1, 12345)
    flat = torch.tensor([TOP_QUANTILE_KEY]) - salts  # flat + salt == key
    got = LG.lazy_gaussian(flat, salts)
    assert torch.isfinite(got).all() and float(got[0, 0]) > 5.0
    ref = np.asarray(JR.lazy_gaussian_pallas(
        jnp.asarray(_u64(flat)), 0, 1, 12345, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ROWS_TOL)


# -- rows ----------------------------------------------------------------------

def test_lazy_gaussian_rows_match_pallas():
    flat = _random_u64(3000, 2)
    ref = np.asarray(JR.lazy_gaussian_pallas(
        jnp.asarray(flat), 3, 16, 777, interpret=True))
    got = LG.lazy_gaussian(_i64(flat), H.drm_salts(3, 16, 777))
    assert got.shape == (13, 3000) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ROWS_TOL)


def test_inds_to_normal_f64_parity():
    rng = np.random.default_rng(3)
    idx = np.stack([rng.integers(0, n, 2000) for n in SHAPE[:3]])
    ref = np.asarray(JH.inds_to_normal(jnp.asarray(idx), SHAPE[:3], 2, 9, 41))
    got = H.inds_to_normal(torch.from_numpy(idx), SHAPE[:3], 2, 9, 41)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


# -- plans ---------------------------------------------------------------------

def _data(shape=SHAPE, nnz=NNZ, seed=6, heavy=False):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape]).astype(np.int64)
    if heavy:
        idx[2, : nnz // 2] = 17  # one value spans more than 16 chunks
    ent = rng.standard_normal(nnz).astype(np.float32)
    return idx, ent


def _packed(pair):
    if pair is None:
        return None
    hi, lo = (np.asarray(x).astype(np.uint64) for x in pair)
    return (hi << np.uint64(32)) | lo


@pytest.mark.parametrize("case", [
    dict(threshold=8, chunk=128), dict(threshold=8, chunk=None),
    dict(threshold=12, chunk=64, heavy=True),
])
def test_plan_matches_jax(case):
    case = dict(case)
    heavy = case.pop("heavy", False)
    idx, ent = _data(heavy=heavy)
    ours = build_psi_plan(idx, SHAPE, entries=ent, device="cpu", **case)
    ref = j_build(idx, SHAPE, entries=ent, **case)
    if heavy:
        assert ref[2].gather_slots is None
    for p, q in zip(ours, ref):
        assert (p is None) == (q is None)
        if p is None:
            continue
        assert (p.n_chunks, p.span, p.chunk) == (q.n_chunks, q.span, q.chunk)
        for name in ("perm", "local_idx", "slot_rows", "sorted_entries",
                     "gather_slots"):
            a, b = getattr(p, name), getattr(q, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        for name in ("flat_left", "flat_right", "flat_left_om"):
            a, b = getattr(p, name), _packed(getattr(q, name))
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(_u64(a), b, name)


def test_window_sized_mode_raises():
    # a mode above window_threshold no longer raises: it gets a WindowPlan
    # (tests/test_torch_window_plan.py holds it against the JAX package);
    # what raises is a window kernel call whose streams do not fit the plan
    from tt_sketch_torch.kernels.sparse_plan import ModePlan, WindowPlan

    idx, ent = _data()
    plans = build_psi_plan(idx, SHAPE, entries=ent, threshold=8,
                           window_threshold=20, device="cpu")
    assert [type(p) for p in plans] == [ModePlan, ModePlan, WindowPlan,
                                        WindowPlan]
    p = plans[2]
    with pytest.raises(ValueError, match="window plan"):
        SP.psi_window_direct(
            p.chunk_window, p.chunk_first, p.local_idx,
            p.sorted_entries[:-1], p.flat_left, p.flat_right,
            H.drm_salts(0, R1, 1), H.drm_salts(0, R2, 2), p.n_chunks, p.span,
            p.chunk, p.n_windows)


# -- kernels' plain versions against the Pallas kernels ------------------------

R1, R2, R1O = 5, 7, 3  # odd ranks: the JAX kernels pad them to 8


@pytest.fixture(scope="module")
def jax_plan():
    idx, ent = _data()
    return idx, ent, j_build(idx, SHAPE, entries=ent, threshold=8,
                             chunk=128)[2]


def _port_plan(jp):
    return mode_plan_from_numpy(
        np.asarray(jp.perm), np.asarray(jp.local_idx),
        np.asarray(jp.slot_rows), jp.n_chunks, jp.span, jp.chunk,
        sorted_entries=np.asarray(jp.sorted_entries),
        flat_left=jp.flat_left, flat_right=jp.flat_right,
        flat_left_om=jp.flat_left_om, gather_slots=jp.gather_slots,
        device="cpu",
    )


def _salts(r, seed):
    return JR.drm_salts(0, r, seed), H.drm_salts(0, r, seed)


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=3e-5 * np.abs(ref).max())


@pytest.mark.parametrize("variant", ["both", "noleft", "noright"])
def test_psi_fused_slabs_matches_pallas(jax_plan, variant):
    _, _, jp = jax_plan
    p = _port_plan(jp)
    (jl, tl), (jr, tr) = _salts(R1, 1), _salts(R2, 2)
    left = variant != "noleft"
    right = variant != "noright"
    ref = JP.psi_fused_slabs(
        jp.local_idx, jp.sorted_entries, jp.flat_left if left else None,
        jp.flat_right if right else None, jl, jr, n_chunks=jp.n_chunks,
        span=jp.span, chunk=jp.chunk, interpret=True)
    got = SP.psi_fused_slabs(
        p.local_idx, p.sorted_entries, p.flat_left if left else None,
        p.flat_right if right else None, tl, tr, p.n_chunks, p.span,
        p.chunk)
    nc, S = jp.n_chunks, jp.span
    ref = np.asarray(ref)
    if left and right:
        ref = ref.reshape(nc, S, ref.shape[1] // S, -1)[:, :, :R1, :R2]
    elif right:
        ref = ref[:, :, :R2].reshape(nc, S, 1, R2)
    else:
        ref = ref[:, :, :R1].reshape(nc, S, R1, 1)
    _close(got, ref)


def test_omega_fused_matches_pallas(jax_plan):
    idx, ent, _ = jax_plan
    (jl, tl), (jr, tr) = _salts(R1, 3), _salts(R2, 4)
    lflat = JH._flat_index_np(idx[:2], SHAPE[:2])
    rflat = JH._flat_index_np(idx[::-1][:2], SHAPE[::-1][:2])
    ref = JP.omega_fused(jnp.asarray(ent), JR.flat_u32_pairs(idx[:2],
                         SHAPE[:2]), JR.flat_u32_pairs(idx[::-1][:2],
                         SHAPE[::-1][:2]), jl, jr, interpret=True)
    got = SP.omega_fused(torch.from_numpy(ent), _i64(lflat), _i64(rflat),
                         tl, tr)
    _close(got, np.asarray(ref)[:R1, :R2])


@pytest.mark.parametrize("left", [True, False])
def test_psi_omega_merged_matches_pallas(jax_plan, left):
    _, _, jp = jax_plan
    p = _port_plan(jp)
    (jl, tl), (jr, tr), (jo, to) = _salts(R1, 5), _salts(R2, 6), _salts(R1O, 7)
    slabs_ref, om_ref = JP.psi_omega_merged_slabs(
        jp.local_idx, jp.sorted_entries, jp.flat_left if left else None,
        jp.flat_right, jp.flat_left_om, jl, jr, jo, n_chunks=jp.n_chunks,
        span=jp.span, chunk=jp.chunk, interpret=True)
    slabs, om = SP.psi_omega_merged_slabs(
        p.local_idx, p.sorted_entries, p.flat_left if left else None,
        p.flat_right, p.flat_left_om, tl, tr, to, p.n_chunks, p.span,
        p.chunk)
    nc, S = jp.n_chunks, jp.span
    slabs_ref = np.asarray(slabs_ref)
    if left:
        slabs_ref = slabs_ref.reshape(nc, S, -1, slabs_ref.shape[2])
        slabs_ref = slabs_ref[:, :, :R1, :R2]
    else:
        slabs_ref = slabs_ref[:, :, :R2].reshape(nc, S, 1, R2)
    _close(slabs, slabs_ref)
    _close(om, np.asarray(om_ref)[:R1O, :R2])


def test_slabs_unpadded_layout(jax_plan):
    # deliberate divergence: no rank padding, slabs (n_chunks, span, r1, r2)
    _, _, jp = jax_plan
    p = _port_plan(jp)
    slabs = SP.psi_fused_slabs(
        p.local_idx, p.sorted_entries, p.flat_left, p.flat_right,
        H.drm_salts(0, R1, 1), H.drm_salts(0, R2, 2), p.n_chunks, p.span,
        p.chunk)
    assert slabs.shape == (p.n_chunks, p.span, R1, R2)
    om = SP.omega_fused(p.sorted_entries, p.flat_left_om, p.flat_right,
                        H.drm_salts(0, R1O, 3), H.drm_salts(0, R2, 4))
    assert om.shape == (R1O, R2)


def test_sign_side_spec_is_not_ported(jax_plan):
    # the sign side spec is ported (tests/test_torch_sparse_sign.py holds
    # it against the Pallas kernels): a well-formed one runs, and what
    # raises now is a malformed spec or salts of another range than [0, nnz)
    _, _, jp = jax_plan
    p = _port_plan(jp)

    def call(salts, spec):
        return SP.psi_fused_slabs(p.local_idx, p.sorted_entries, p.flat_left,
                                  None, salts, None, p.n_chunks, p.span,
                                  p.chunk, lspec=spec)

    assert call(H.drm_salts(0, 2, 1), ("s", 4, 2, 0, 4)).shape == (
        p.n_chunks, p.span, 4, 1)
    with pytest.raises(ValueError, match=r"columns \[0, nnz\)"):
        call(H.drm_salts(0, 4, 1), ("s", 4, 2, 0, 4))
    with pytest.raises(ValueError, match="rank slice"):
        call(H.drm_salts(0, 2, 1), ("s", 4, 2, 2, 4))
    with pytest.raises(ValueError, match="side spec"):
        call(H.drm_salts(0, 2, 1), ("s", 4, 2))
