"""Giant-mode window plans of the port against the JAX package:
``WindowPlan`` / ``build_window_plan``, the plain version of
``psi_window_direct`` (both variants; Gaussian, sign and mixed sides), and
``stream_sketch`` with window plans on first, interior and last modes.

Reference side: the JAX ``build_window_plan`` (equal field by field), the
Pallas window kernel in interpret mode on the CPU
(``TT_SKETCH_TPU_FORCE_TPU=1``, ``TT_SKETCH_TPU_PALLAS_INTERPRET=1``) and the
JAX package's float64 parity path.  Tolerances, with their reasons:

- plans: exactly equal (integer code; the port keeps each flat stream as
  one int64 tensor where the JAX plan has a uint32 pair);
- Ψ rows and whole sketches in float32: ``3e-5·max|ref|`` (float32 sums in
  another order and the two implementations' erfinv rounding);
- float64 sketches: 1e-10 (the same rows, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_sketch_tpu as jts
from tt_sketch_torch import config, profiling
from tt_sketch_torch.data.frostt import load_frostt
from tt_sketch_torch.drm import SparseGaussianDRM, SparseSignDRM
from tt_sketch_torch.engine.sketch import stream_sketch
from tt_sketch_torch.formats import SparseTensor
from tt_sketch_torch.interop import window_plan_from_numpy
from tt_sketch_torch.kernels import sketch_kernels as K
from tt_sketch_torch.kernels import sparse_psi as SP
from tt_sketch_torch.kernels.sparse_plan import (
    ModePlan,
    WindowPlan,
    build_psi_plan,
    build_window_plan,
)
from tt_sketch_torch.rng import hash_rng as H
from tt_sketch_tpu.drm import SparseGaussianDRM as JSG
from tt_sketch_tpu.drm.sparse_sign_drm import SparseSignDRM as JSS
from tt_sketch_tpu.formats import SparseTensor as JST
from tt_sketch_tpu.kernels import pallas_psi as JP
from tt_sketch_tpu.kernels import pallas_rng as JR
from tt_sketch_tpu.kernels.sparse_plan import WindowPlan as JWindowPlan
from tt_sketch_tpu.kernels.sparse_plan import build_psi_plan as j_build
from tt_sketch_tpu.kernels.sparse_plan import build_window_plan as j_window

SHAPE = (11, 9, 300, 25)
NNZ = 1500
PSI_REL = 3e-5
ARRAYS = ("local_idx", "chunk_window", "chunk_first", "sorted_entries")
FLATS = ("flat_left", "flat_right")
GEOMETRY = ("n_chunks", "span", "chunk", "n_windows")


def _launches(wrapper):
    """The launches counted for kernel wrapper ``wrapper`` so far."""
    return profiling.counters().get(f"launches.{wrapper}", 0)


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


def _data(dtype=np.float32, seed=23, shape=SHAPE, nnz=NNZ, skew_mode=2):
    """Random COO data; ``skew_mode`` gets hot rows (windows of several
    chunks) and a gap (empty windows)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape]).astype(np.int64)
    n = shape[skew_mode]
    idx[skew_mode] = np.where(rng.random(nnz) < 0.5,
                              rng.integers(0, max(n // 15, 1), nnz),
                              rng.integers(n - n // 6, n, nnz))
    ent = rng.standard_normal(nnz).astype(dtype)
    return idx, ent


def _packed(pair):
    if pair is None:
        return None
    hi, lo = (np.asarray(x).astype(np.uint64) for x in pair)
    return (hi << np.uint64(32)) | lo


def _u64(t):
    return t.numpy().view(np.uint64)


def _assert_plans_equal(p, q):
    """A port ``WindowPlan`` against a JAX one, field by field."""
    assert isinstance(p, WindowPlan) and isinstance(q, JWindowPlan)
    assert [getattr(p, g) for g in GEOMETRY] == [getattr(q, g)
                                                 for g in GEOMETRY]
    for name in ARRAYS:
        a, b = getattr(p, name), getattr(q, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    for name in FLATS:
        a, b = getattr(p, name), _packed(getattr(q, name))
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == torch.int64  # one stream, not a uint32 pair
            np.testing.assert_array_equal(_u64(a), b, name)
    assert p.flat_left_om is None and p.gather_slots is None


# -- build_window_plan ----------------------------------------------------------

@pytest.mark.parametrize("mu", [0, 2, 3])
@pytest.mark.parametrize("geom", [dict(span=32, chunk=128),
                                  dict(span=60, chunk=64), dict()])
def test_window_plan_matches_jax(mu, geom):
    # span 60 is rounded up to 64; the default is span 256, chunk 512
    idx, ent = _data(skew_mode=mu)
    kw = dict(full_indices=idx, mu=mu, shape=SHAPE, entries=ent, **geom)
    ours = build_window_plan(idx[mu], SHAPE[mu], device="cpu", **kw)
    ref = j_window(idx[mu], SHAPE[mu], **kw)
    _assert_plans_equal(ours, ref)
    assert (ours.flat_left is None) == (mu == 0)
    assert (ours.flat_right is None) == (mu == len(SHAPE) - 1)
    if not geom:
        assert (ours.span, ours.chunk) == (256, 512)


def test_window_plan_without_streams_matches_jax():
    idx, _ = _data()
    ours = build_window_plan(idx[2], SHAPE[2], span=32, chunk=128,
                             device="cpu")
    _assert_plans_equal(ours, j_window(idx[2], SHAPE[2], span=32, chunk=128))
    assert ours.sorted_entries is None and ours.map_entries(abs) is ours


def test_window_plan_from_numpy_round_trip():
    # the other way round: a JAX plan's arrays handed to the port
    idx, ent = _data()
    ref = j_window(idx[2], SHAPE[2], span=32, chunk=128, full_indices=idx,
                   mu=2, shape=SHAPE, entries=ent)
    ours = window_plan_from_numpy(
        ref.local_idx, ref.chunk_window, ref.chunk_first, ref.n_chunks,
        ref.span, ref.chunk, ref.n_windows, sorted_entries=ref.sorted_entries,
        flat_left=ref.flat_left, flat_right=ref.flat_right, device="cpu")
    _assert_plans_equal(ours, ref)
    built = build_window_plan(idx[2], SHAPE[2], span=32, chunk=128,
                              full_indices=idx, mu=2, shape=SHAPE,
                              entries=ent, device="cpu")
    for name in ARRAYS + FLATS:
        assert torch.equal(getattr(ours, name), getattr(built, name)), name


def test_window_plan_invariants():
    """Every nnz lands in its aligned window's run, pads are sentinels with
    zero entries at the end of the run, every window has a chunk and its
    first chunk flagged, rows do not decrease inside a window."""
    rng = np.random.default_rng(3)
    n_mu = 1000
    idx = np.concatenate([
        rng.integers(0, 80, 400),      # hot window region
        rng.integers(900, 1000, 50),   # sparse tail
        np.full(300, 7),               # hot single row
    ])
    ent = rng.standard_normal(idx.shape[0]).astype(np.float32)
    full = np.stack([idx, rng.integers(0, 5, idx.shape[0])])
    p = build_window_plan(idx, n_mu, span=64, chunk=128, full_indices=full,
                          mu=0, shape=(n_mu, 5), entries=ent, device="cpu")
    assert p.n_windows == -(-n_mu // 64)
    assert p.chunk_window.shape == (p.n_chunks,)
    assert int(p.chunk_first.sum()) == p.n_windows
    win = p.chunk_window.numpy()
    assert (np.diff(win) >= 0).all() and set(win) == set(range(p.n_windows))
    first = p.chunk_first.numpy()
    assert (first[1:] == (np.diff(win) > 0)).all() and first[0] == 1
    loc = p.local_idx.numpy().reshape(p.n_chunks, p.chunk)
    se = p.sorted_entries.numpy().reshape(p.n_chunks, p.chunk)
    rows = []
    for c in range(p.n_chunks):
        real = loc[c] < p.span
        rows.extend((win[c] * p.span + loc[c][real]).tolist())
        assert (se[c][~real] == 0).all()
    np.testing.assert_array_equal(np.sort(rows), np.sort(idx))
    for w in range(p.n_windows):
        run = loc[win == w].reshape(-1)
        assert (np.diff(run) >= 0).all()  # sorted rows, then the pads
    assert float(np.abs(se).sum()) == pytest.approx(float(np.abs(ent).sum()),
                                                    rel=1e-6)


def test_build_psi_plan_picks_window_plans_as_jax():
    idx, ent = _data()
    kw = dict(entries=ent, threshold=8, chunk=128, window_threshold=100,
              window_span=32)
    ours = build_psi_plan(idx, SHAPE, device="cpu", **kw)
    ref = j_build(idx, SHAPE, **kw)
    assert [type(p).__name__ for p in ours] == [type(q).__name__
                                                for q in ref]
    assert [type(p) for p in ours] == [ModePlan, ModePlan, WindowPlan,
                                       ModePlan]
    _assert_plans_equal(ours[2], ref[2])
    # without entries a giant mode keeps the plain sort/chunk plan, as in
    # the JAX package
    bare = build_psi_plan(idx, SHAPE, threshold=8, window_threshold=100,
                          device="cpu")
    assert isinstance(bare[2], ModePlan)


def test_sparse_tensor_carries_window_plans():
    idx, ent = _data(np.float64)
    t = SparseTensor(SHAPE, idx, ent).with_psi_plan(
        threshold=8, chunk=128, window_threshold=100, window_span=32)
    p = t.psi_plan[2]
    assert isinstance(p, WindowPlan) and repr(p).startswith("<WindowPlan")
    q = t.T.psi_plan[1]
    assert isinstance(q, WindowPlan)
    assert q.flat_left is p.flat_right and q.flat_right is p.flat_left
    assert q.local_idx is p.local_idx and q.n_windows == p.n_windows
    scaled = (t * 3.0).psi_plan[2]
    np.testing.assert_allclose(scaled.sorted_entries.numpy(),
                               3 * p.sorted_entries.numpy())
    cast = t.astype(torch.float32).psi_plan[2]
    assert cast.sorted_entries.dtype == torch.float32
    assert cast.chunk_window is p.chunk_window


def test_load_frostt_passes_window_kwargs(tmp_path):
    idx, ent = _data(np.float64)
    np.savez(tmp_path / "lbnl-synthetic.npz", indices=idx, entries=ent,
             shape=np.asarray(SHAPE), synth_version=np.asarray(2))
    t = load_frostt("lbnl-synthetic", cache_dir=tmp_path, psi_plan=True,
                    plan_kwargs=dict(threshold=8, window_threshold=100,
                                     window_span=32))
    assert [type(p) for p in t.psi_plan] == [ModePlan, ModePlan, WindowPlan,
                                             ModePlan]
    assert t.psi_plan[2].span == 32


def test_lbnl_last_mode_gets_a_window_plan():
    # the committed FROSTT-lbnl stand-in under the default plan: four
    # sort/chunk plans and a WindowPlan on the 868131-row last mode
    t = load_frostt("lbnl-synthetic", psi_plan=True)
    assert t.shape == (1605, 4198, 1631, 4209, 868131) and t.nnz == 1698825
    assert [type(p) for p in t.psi_plan] == [ModePlan] * 4 + [WindowPlan]
    assert all(p.flat_left_om is not None for p in t.psi_plan[:4])
    p = t.psi_plan[4]
    assert (p.span, p.chunk, p.n_windows) == (256, 512, -(-868131 // 256))
    assert p.flat_right is None and p.flat_left.shape[0] == p.n_chunks * 512
    per_window = np.bincount(p.chunk_window.numpy(), minlength=p.n_windows)
    assert per_window.min() >= 1 and per_window.sum() == p.n_chunks
    ref = j_window(t.indices[4].numpy(), 868131)
    assert (ref.n_chunks, ref.n_windows) == (p.n_chunks, p.n_windows)
    np.testing.assert_array_equal(p.local_idx.numpy(),
                                  np.asarray(ref.local_idx))
    np.testing.assert_array_equal(p.chunk_window.numpy(),
                                  np.asarray(ref.chunk_window))


# -- the window kernel's plain version against the Pallas kernel --------------------

SIDES = {
    "g5": (5, None),
    "g7": (7, None),
    "s5": (5, ("s", 5, 5, 0, 5)),
    "s7few": (7, ("s", 7, 3, 0, 7)),
    "s4of9": (4, ("s", 9, 9, 3, 4)),
}


def _side(name, seed):
    """(rows, spec, port salts, JAX salts) of a side; the JAX kernels take
    a sign side's salts padded to the full working range."""
    r, spec = SIDES[name]
    if spec is None:
        return r, ("g",), H.drm_salts(0, r, seed), JR.drm_salts(0, r, seed)
    _, rank, nnz, rank_min, r_out = spec
    r_full = -(-max(rank, rank_min + -(-max(r_out, 1) // 8) * 8) // 8) * 8
    return r, spec, H.drm_salts(0, nnz, seed), JR.drm_salts(0, r_full, seed)


@pytest.fixture(scope="module")
def window_plans():
    idx, ent = _data()
    kw = dict(span=32, chunk=128, full_indices=idx, mu=2, shape=SHAPE,
              entries=ent)
    return (build_window_plan(idx[2], SHAPE[2], device="cpu", **kw),
            j_window(idx[2], SHAPE[2], **kw))


@pytest.mark.parametrize("left,right", [
    ("g5", "g7"), ("s5", "s7few"), ("s5", "g7"), ("g5", "s4of9"),
    (None, "g7"), (None, "s7few"), ("g5", None), ("s4of9", None),
])
def test_psi_window_direct_matches_pallas(window_plans, left, right):
    p, jp = window_plans
    # multi-chunk windows and empty windows are both present
    per_window = np.bincount(p.chunk_window.numpy())
    assert per_window.max() > 1
    occupied = np.unique(p.chunk_window.numpy()[
        (p.local_idx.numpy().reshape(p.n_chunks, -1) < p.span).any(1)])
    assert occupied.shape[0] < p.n_windows
    r1, lspec, tl, jl = _side(left or "g5", 1)
    r2, rspec, tr, jr = _side(right or "g7", 2)
    ref = np.asarray(JP.psi_window_direct(
        jp.chunk_window, jp.chunk_first, jp.local_idx, jp.sorted_entries,
        jp.flat_left if left else None, jp.flat_right if right else None,
        jl if left else None, jr if right else None, n_chunks=jp.n_chunks,
        span=jp.span, chunk=jp.chunk, n_windows=jp.n_windows, interpret=True,
        lspec=lspec, rspec=rspec))
    got = SP.psi_window_direct(
        p.chunk_window, p.chunk_first, p.local_idx, p.sorted_entries,
        p.flat_left if left else None, p.flat_right if right else None,
        tl if left else None, tr if right else None, p.n_chunks, p.span,
        p.chunk, p.n_windows, lspec, rspec)
    nw, S = jp.n_windows, jp.span
    if left and right:
        ref = ref.reshape(nw, S, ref.shape[1] // S, -1)[:, :, :r1, :r2]
        ref = ref.reshape(nw * S, r1, r2)
    elif right:
        ref = ref[:, :, :r2].reshape(nw * S, 1, r2)
    else:
        ref = ref[:, :, :r1].reshape(nw * S, r1, 1)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=PSI_REL * np.abs(ref).max())
    # rows of empty windows and past the mode end are exactly zero
    empty = np.setdiff1d(np.arange(nw), occupied)
    assert not got.reshape(nw, S, -1)[empty].any()
    assert not got[SHAPE[2]:].any()


def test_psi_window_direct_checks_its_operands(window_plans):
    p, _ = window_plans
    args = (p.chunk_window, p.chunk_first, p.local_idx, p.sorted_entries)
    geom = (p.n_chunks, p.span, p.chunk, p.n_windows)
    with pytest.raises(ValueError, match="left or a right"):
        SP.psi_window_direct(*args, None, None, None, None, *geom)
    with pytest.raises(ValueError, match="win/first"):
        SP.psi_window_direct(p.chunk_window[:-1], *args[1:], p.flat_left,
                             None, H.drm_salts(0, 3, 1), None, *geom)
    before = _launches("psi_window_direct")
    SP.psi_window_direct(*args, p.flat_left, None, H.drm_salts(0, 3, 1),
                         None, *geom)
    assert _launches("psi_window_direct") == before  # CPU: the plain version


# -- the slice as a whole ----------------------------------------------------------

PAIRS = {
    "gauss_gauss": (SparseGaussianDRM, SparseGaussianDRM, JSG, JSG),
    "sign_sign": (SparseSignDRM, SparseSignDRM, JSS, JSS),
    "sign_gauss": (SparseSignDRM, SparseGaussianDRM, JSS, JSG),
    "gauss_sign": (SparseGaussianDRM, SparseSignDRM, JSG, JSS),
}

#: where the giant mode sits: (shape, its mode)
PLACES = {
    "first": ((300, 9, 11, 25), 0),
    "interior": ((11, 9, 300, 25), 2),
    "last": ((11, 9, 25, 300), 3),
}
PLAN_KW = dict(threshold=8, chunk=128, window_threshold=100, window_span=32)


def _tensors(place, dtype):
    shape, mode = PLACES[place]
    idx, ent = _data(dtype, shape=shape, skew_mode=mode)
    ours = SparseTensor(shape, idx, ent).with_psi_plan(**PLAN_KW)
    ref = JST(shape, idx, ent).with_psi_plan(indices=idx, entries=ent,
                                             **PLAN_KW)
    assert isinstance(ours.psi_plan[mode], WindowPlan)
    assert isinstance(ref.psi_plan[mode], JWindowPlan)
    return ours, ref


@pytest.mark.parametrize("place", PLACES, ids=list(PLACES))
@pytest.mark.parametrize("pair", PAIRS, ids=list(PAIRS))
def test_stream_sketch_window_f32_matches_pallas(pallas_interpret, pair,
                                                 place):
    lt, rt, jlt, jrt = PAIRS[pair]
    t, jt = _tensors(place, np.float32)
    kw = dict(left_rank=4, right_rank=8, seed=5)
    sk = stream_sketch(t, left_drm_type=lt, right_drm_type=rt,
                       dtype=torch.float32, **kw)
    jsk = jts.stream_sketch(jt, left_drm_type=jlt, right_drm_type=jrt,
                            dtype=jnp.float32, **kw)
    for a, b in zip(sk.Psi_cores + sk.Omega_mats,
                    jsk.Psi_cores + jsk.Omega_mats):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=PSI_REL * np.abs(b).max())


@pytest.mark.parametrize("place", PLACES, ids=list(PLACES))
@pytest.mark.parametrize("pair", ["gauss_gauss", "sign_gauss"])
def test_stream_sketch_window_f64_matches_jax(pair, place):
    # float64 takes the segment path over materialized rows and ignores
    # the window plan, as float64 does with sort/chunk plans
    lt, rt, jlt, jrt = PAIRS[pair]
    t, jt = _tensors(place, np.float64)
    kw = dict(left_rank=4, right_rank=8, seed=5)
    sk = stream_sketch(t, left_drm_type=lt, right_drm_type=rt, **kw)
    jsk = jts.stream_sketch(jt, left_drm_type=jlt, right_drm_type=jrt, **kw)
    for a, b in zip(sk.Psi_cores + sk.Omega_mats,
                    jsk.Psi_cores + jsk.Omega_mats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("place", PLACES, ids=list(PLACES))
def test_window_mode_never_merges(place, monkeypatch):
    # a WindowPlan has no inclusive prefix: its Ψ comes from the window
    # kernel and its Ω from omega_fused; the other planned modes merge
    shape, mode = PLACES[place]
    t, _ = _tensors(place, np.float32)
    calls = {}
    for name in ("psi_window_direct", "omega_fused",
                 "psi_omega_merged_slabs", "psi_fused_slabs"):
        fn = getattr(K, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(K, name, counted)
    stream_sketch(t, 4, 8, seed=1, left_drm_type=SparseGaussianDRM,
                  right_drm_type=SparseGaussianDRM, dtype=torch.float32)
    d = len(shape)
    planned = sum(p is not None for p in t.psi_plan)
    last_is_window = mode == d - 1
    merged = sum(p is not None and not isinstance(p, WindowPlan)
                 for p in t.psi_plan[:d - 1])
    assert calls["psi_window_direct"] == 1
    assert calls.get("psi_omega_merged_slabs", 0) == merged
    assert calls.get("omega_fused", 0) == d - 1 - merged
    assert calls.get("psi_fused_slabs", 0) == planned - merged - 1
    assert last_is_window == (t.psi_plan[d - 1].__class__ is WindowPlan)
