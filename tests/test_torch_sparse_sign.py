"""The sparse-sign DRM of the port against the JAX package: the generator's
two contracts, ``SparseSignDRM``, the sign and mixed side specs of the fused
Ψ/Ω kernels' plain versions, and ``stream_sketch`` with sign pairs.

Reference side: ``inds_to_sparse_sign_np`` (the float64 host oracle), the
Pallas generator and fused kernels in interpret mode on the CPU
(``TT_SKETCH_TPU_FORCE_TPU=1``, ``TT_SKETCH_TPU_PALLAS_INTERPRET=1``), and
the JAX package's float64 parity path.  Tolerances, with their reasons:

- sign rows: exactly equal (values are -1, 0, +1 and the swap positions
  are integers);
- Ψ slabs and Ω blocks against the Pallas kernels: ``3e-5·max|ref|``
  (float32 sums in another order; with a Gaussian side also the two
  implementations' float32 erfinv rounding, as in
  ``tests/test_torch_sparse_kernels.py``);
- float64 sketches: 1e-10 (the same rows, summed in another order).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_sketch_tpu as jts
from tt_sketch_torch import config, profiling
from tt_sketch_torch.drm import SparseGaussianDRM, SparseSignDRM
from tt_sketch_torch.engine.sketch import stream_sketch
from tt_sketch_torch.formats import SparseTensor
from tt_sketch_torch.interop import mode_plan_from_numpy
from tt_sketch_torch.kernels import lazy_gaussian as LG
from tt_sketch_torch.kernels import sketch_kernels as K
from tt_sketch_torch.kernels import sparse_psi as SP
from tt_sketch_torch.kernels import sparse_sign as SS
from tt_sketch_torch.rng import hash_rng as H
from tt_sketch_tpu.drm import SparseGaussianDRM as JSG
from tt_sketch_tpu.drm.sparse_sign_drm import SparseSignDRM as JSS
from tt_sketch_tpu.formats import SparseTensor as JST
from tt_sketch_tpu.kernels import pallas_psi as JP
from tt_sketch_tpu.kernels import pallas_rng as JR
from tt_sketch_tpu.kernels.sparse_plan import build_psi_plan as j_build
from tt_sketch_tpu.rng import hash_rng as JH

SHAPE = (11, 9, 30, 25)
NNZ = 1500
PSI_REL = 3e-5


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


def _i64(a_u64):
    return torch.from_numpy(np.ascontiguousarray(a_u64).view(np.int64))


def _data(dtype=np.float32, seed=21, nnz=NNZ, shape=SHAPE):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape]).astype(np.int64)
    ent = rng.standard_normal(nnz).astype(dtype)
    return idx, ent


# -- the generator ---------------------------------------------------------------

def test_swap_position_is_the_exact_integer():
    # against Python's unbounded integers, up to the largest range; the
    # plain u52·m product would overflow int64 from m = 2^11 on
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2 ** 63, 4096, dtype=np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, 4096, dtype=np.uint64)
    h[:3] = [2 ** 64 - 1, 2 ** 52 - 1, 0]
    for m, j in [(1, 0), (10, 3), (2 ** 11 + 1, 0), (4097, 5), (70001, 9),
                 (2 ** 31 - 1, 0)]:
        got = H.swap_position(_i64(h), m, j).numpy()
        want = [((int(x) & (2 ** 52 - 1)) * m >> 52) + j for x in h]
        assert got.tolist() == want, (m, j)
        assert got.min() >= j and got.max() < m + j
    with pytest.raises(ValueError, match="swap range"):
        H.swap_position(_i64(h), 2 ** 31, 0)


SIGN_CASES = {
    "full": dict(rank=10, rank_min=0, rank_max=10, nnz=10),
    "few": dict(rank=12, rank_min=0, rank_max=12, nnz=3),
    "slice": dict(rank=20, rank_min=5, rank_max=13, nnz=20),
    "slice_few": dict(rank=17, rank_min=9, rank_max=17, nnz=4),
    "one": dict(rank=1, rank_min=0, rank_max=1, nnz=1),
    "rank>4096": dict(rank=5000, rank_min=4090, rank_max=4130, nnz=3),
}


@pytest.mark.parametrize("case", SIGN_CASES, ids=list(SIGN_CASES))
def test_sign_rows_bit_exact(case):
    c = SIGN_CASES[case]
    n = 300 if c["rank"] > 4096 else 2000
    idx, _ = _data(nnz=n, seed=3)
    seed = 77
    ref = JH.inds_to_sparse_sign_np(
        idx[:3], SHAPE[:3], c["rank"], c["rank_min"], c["rank_max"],
        c["nnz"], seed).T.astype(np.float32)
    pallas = np.asarray(JR.inds_to_sparse_sign_pallas(
        jnp.asarray(idx[:3]), SHAPE[:3], c["rank"], c["rank_min"],
        c["rank_max"], c["nnz"], seed, interpret=True))
    flat = H.flat_index(torch.from_numpy(idx[:3]), SHAPE[:3])
    got = SS.sparse_sign_rows(flat, H.drm_salts(0, c["nnz"], seed),
                              c["rank"], c["nnz"], c["rank_min"],
                              c["rank_max"])
    assert got.dtype == torch.float32
    assert got.shape == (c["rank_max"] - c["rank_min"], n)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), pallas)
    # the float64 parity generator draws the same rows
    parity = H.inds_to_sparse_sign(
        torch.from_numpy(idx[:3]), SHAPE[:3], c["rank"], c["rank_min"],
        c["rank_max"], c["nnz"], seed)
    assert parity.dtype == torch.float64
    np.testing.assert_array_equal(parity.numpy().T, ref)
    if c["rank_min"] == 0 and c["rank_max"] == c["rank"]:
        # exactly nnz non-zeros per column of the full shuffle
        assert (got.abs().sum(0) == c["nnz"]).all()


def test_sign_rows_take_flats_above_2_63():
    rng = np.random.default_rng(5)
    flat = rng.integers(2 ** 63, 2 ** 64, 1000, dtype=np.uint64)
    pair = (jnp.asarray((flat >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    ref = np.asarray(JR.sparse_sign_pallas_from_pairs(
        pair, 9, 0, 9, 4, 123, interpret=True))
    got = SS.sparse_sign_rows(_i64(flat), H.drm_salts(0, 4, 123), 9, 4, 0, 9)
    np.testing.assert_array_equal(got.numpy(), ref)


# -- the kernel's register algorithm for rank <= 32, emulated in numpy ---------
#
# csrc/sparse_sign.cu hashes each draw once (hash_rng.cuh:sign_column_word):
# the flat index carries the hash's first constant; the fields j < nnz of
# one word start at 11 (-1, 2 bits a slot: 00 = 0, 01 = +1) and bit 52 of
# draw j flips the high bit of field j; twice the swap position (32-bit limb
# form) is kept; then the swaps exchange fields by an XOR and the output
# reads fields as float bit patterns (sign_slot).  Draws go in groups (the
# last group's draws past nnz hash a zero salt, are masked and swap
# nothing).  The rank buckets and group sizes are read from the source.

SIGN_SRC_DIR = Path(__file__).resolve().parents[1] / "tt_sketch_torch" / "csrc"
SIGN_SRC = (SIGN_SRC_DIR / "sparse_sign.cu").read_text()
SIGN_BUCKETS = sorted({int(b) for b in
                       re.findall(r"launch_regs<(\d+)>\(", SIGN_SRC)})
_GROUPS = re.search(r"return rb > (\d+) \? (\d+) : (\d+);", SIGN_SRC)


def _draw_group(bucket):
    edge, big, small = map(int, _GROUPS.groups())
    return big if bucket > edge else small


def _mix64(x):
    """splitmix64 after its first add (hash_rng.cuh:mix64), uint64."""
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _emulate_sign_word(flat, salts, rank, nnz, rank_min, rank_max):
    """The register kernel's rows, step for step, on uint64 flats and
    salts: (rank_max - rank_min, N) float32."""
    bucket = next(b for b in SIGN_BUCKETS if rank <= b)
    group = _draw_group(bucket)
    n_draws = -(-nnz // group) * group                 # whole groups
    salts = np.concatenate([salts, np.zeros(n_draws - nnz, np.uint64)])
    base = flat + np.uint64(0x4BE98134A5976FD3)
    w0 = np.uint64((1 << 2 * nnz) - 1)
    w = np.full(flat.shape, w0, np.uint64)
    at = []
    for j in range(n_draws):                               # pass 1
        h = _mix64(base + salts[j])
        hi = h >> np.uint64(32)
        lo = h & np.uint64(0xFFFFFFFF)
        w ^= (((h >> np.uint64(52)) & np.uint64(1)) << np.uint64(2 * j + 1)
              & w0)
        m = np.uint64(rank - j if j < nnz else 0)
        s32 = (hi & np.uint64(0xFFFFF)) * m + ((lo * m) >> np.uint64(32))
        assert (s32 < np.uint64(1 << 32)).all()       # fits 32 bits
        rp = (s32 >> np.uint64(20)) + np.uint64(j)
        assert (rp >= j).all() and (rp < max(rank, j + 1)).all()
        at.append(np.uint64(2) * rp)
    for j in range(n_draws):                               # pass 2
        x = ((w >> np.uint64(2 * j)) ^ (w >> at[j])) & np.uint64(3)
        w ^= (x << np.uint64(2 * j)) | (x << at[j])
    if bucket <= 16:                        # one 32-bit word of 16 fields
        assert (w >> np.uint64(32) == 0).all()
    v = w >> np.uint64(2 * rank_min)
    out = np.empty((rank_max - rank_min, flat.shape[0]), np.uint32)
    for r in range(rank_max - rank_min):                   # sign_slot
        f = ((v >> np.uint64(2 * r)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out[r] = (f << np.uint32(30)) - ((f & np.uint32(1)) << np.uint32(23))
    return out.view(np.float32)


SIGN_WORD_CASES = {
    **{f"rank{r}_full": (r, r, 0, r) for r in (1, 10, 16, 17, 20, 32)},
    **{f"rank{r}_few": (r, n, 0, r) for r, n in ((10, 3), (16, 15),
                                                 (17, 5), (20, 1),
                                                 (32, 31))},
    "rank20_slice": (20, 20, 5, 13),
    "rank17_slice_few": (17, 4, 9, 17),
    "rank32_last_slot": (32, 32, 31, 32),
    "rank16_slice_few": (16, 7, 0, 9),
}


@pytest.mark.parametrize("high", [False, True], ids=["flats", "flats>2^63"])
@pytest.mark.parametrize("case", SIGN_WORD_CASES, ids=list(SIGN_WORD_CASES))
def test_register_sign_column_matches_pallas(pallas_interpret, case, high):
    rank, nnz, lo, hi = SIGN_WORD_CASES[case]
    rng = np.random.default_rng(rank * 100 + nnz + lo)
    flat = rng.integers(0, 2 ** 63, 1500, dtype=np.uint64)
    if high:
        flat |= np.uint64(1 << 63)
    seed = 1000 + rank
    salts = H.drm_salts(0, nnz, seed).numpy().view(np.uint64)
    got = _emulate_sign_word(flat, salts, rank, nnz, lo, hi)
    # the hash of the port's contract: mix64 after the first add
    np.testing.assert_array_equal(
        _mix64(flat + salts[0] + np.uint64(0x4BE98134A5976FD3)),
        H.hash_int_np(flat + salts[0]))
    pair = (jnp.asarray((flat >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    pallas = np.asarray(JR.sparse_sign_pallas_from_pairs(
        pair, rank, lo, hi, nnz, seed))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  pallas.view(np.uint32))
    h = H.hash_int(_i64(flat)[None, :] + H.drm_salts(0, nnz, seed)[:, None])
    bits = H.sparse_sign_from_bits(h, rank, lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), bits.view(np.uint32))
    if lo == 0 and hi == rank:
        assert (np.abs(got).sum(0) == nnz).all()


def test_register_buckets_cover_the_paths_ranks():
    # every rank the sketches use (10, 20) and every rank up to 32 takes a
    # register instance; the 32-bit limb swap position holds up to 4096
    assert SIGN_BUCKETS == [16, 32]
    assert [_draw_group(b) for b in SIGN_BUCKETS] == [2, 4]
    assert all(any(r <= b for b in SIGN_BUCKETS) for r in range(1, 33))
    assert "sparse_sign_kernel<<<" in SIGN_SRC      # larger ranks


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)``: byte i of the result is byte
    ``(s >> 4i) & 7`` of the eight bytes of ``y:x``."""
    b = [(x >> 8 * i) & 0xFF for i in range(4)] + \
        [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(s >> 4 * i) & 7] << 8 * i for i in range(4))


@pytest.mark.parametrize("bucket", [16, 32])
def test_packed_swap_slots_round_trip(bucket):
    # hash_rng.cuh:SwapSlots<RB, true>, the fused kernels' sign words: twice
    # each swap position (at most 62) as one byte, four to a register, set
    # in draw order and read back; selectors as written in the header
    src = (SIGN_SRC_DIR / "hash_rng.cuh").read_text()
    assert "(0x3210u & ~(0xFu << k)) | (4u << k)" in src
    assert "__byte_perm(v[j >> 2], 0u, 0x4440u | (j & 3))" in src
    rng = np.random.default_rng(bucket)
    values = [int(v) for v in 2 * rng.integers(0, 32, bucket)]
    words = [0] * (bucket // 4)
    for j, a in enumerate(values):
        k = 4 * (j & 3)
        words[j >> 2] = a if k == 0 else _byte_perm(
            words[j >> 2], a, (0x3210 & ~(0xF << k)) | (4 << k))
    assert [_byte_perm(words[j >> 2], 0, 0x4440 | (j & 3))
            for j in range(bucket)] == values


def test_sign_rows_reject_wrong_salts_and_slices():
    flat = torch.arange(10)
    with pytest.raises(ValueError, match=r"columns \[0, nnz\)"):
        SS.sparse_sign_rows(flat, H.drm_salts(0, 8, 1), 8, 4, 0, 8)
    with pytest.raises(ValueError, match="non-zeros per row"):
        SS.sparse_sign_rows(flat, H.drm_salts(0, 9, 1), 8, 9, 0, 8)
    with pytest.raises(ValueError, match="rank slice"):
        SS.sparse_sign_rows(flat, H.drm_salts(0, 4, 1), 8, 4, 3, 9)


@pytest.mark.parametrize("sides,fits", [
    # (flat present, spec, r) per side; 866 rows with a salt each fit a block
    ([(True, ("s", 433, 433, 0, 10), 10), (True, ("s", 433, 433, 0, 20), 20)],
     True),
    ([(True, ("s", 434, 434, 0, 10), 10), (True, ("s", 433, 433, 0, 20), 20)],
     False),
    # a sliced side still allocates its whole rank; a missing side one row
    ([(True, ("s", 900, 4, 0, 2), 2), (False, ("g",), 1)], False),
    ([(True, ("g",), 800), (False, ("g",), 1)], True),
    ([(True, ("g",), 300), (True, ("g",), 300), (True, ("s", 300, 1, 0, 5), 5)],
     False),
], ids=["two_sign_433", "two_sign_434", "sliced_900", "gauss_800",
        "merged_900"])
def test_fused_kernels_name_their_rank_limit(sides, fits):
    sides = [(torch.zeros(1) if has else None, spec, r)
             for has, spec, r in sides]
    if fits:
        SP._check_shared_memory("psi_fused_slabs", *sides)
    else:
        with pytest.raises(ValueError, match="shared memory per block"):
            SP._check_shared_memory("psi_fused_slabs", *sides)


# -- the DRM ---------------------------------------------------------------------

DRM_CASES = {
    "left": dict(rank=(4, 6, 5), transpose=False),
    "right": dict(rank=(4, 6, 5), transpose=True),
    "left_nnz": dict(rank=(4, 6, 5), transpose=False,
                     num_non_zero_per_row=(2, 3, 1)),
    "right_nnz": dict(rank=(4, 6, 5), transpose=True,
                      num_non_zero_per_row=(2, 3, 1)),
}


@pytest.mark.parametrize("case", DRM_CASES, ids=list(DRM_CASES))
def test_sign_drm_f64_rows_equal_jax(case):
    # the DRM has no weights: built from the same (rank, shape, transpose,
    # seed, num_non_zero_per_row) both sides draw the same rows
    kw = DRM_CASES[case]
    idx, ent = _data(np.float64)
    ours = SparseSignDRM(shape=SHAPE, seed=31, **kw)
    ref = JSS(shape=SHAPE, seed=31, **kw)
    assert (ours.nnz, ours.true_rank, ours.rank) == (
        tuple(ref.nnz), ref.true_rank, ref.rank)
    got = ours.sketch_sparse(SparseTensor(SHAPE, idx, ent))
    want = ref.sketch_sparse(JST(SHAPE, idx, ent))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", DRM_CASES, ids=list(DRM_CASES))
def test_sign_drm_f32_rows_equal_pallas(pallas_interpret, case):
    kw = DRM_CASES[case]
    idx, ent = _data()
    ours = SparseSignDRM(shape=SHAPE, seed=32, dtype=torch.float32, **kw)
    ref = JSS(shape=SHAPE, seed=32, dtype=jnp.float32, **kw)
    got = ours.sketch_sparse(SparseTensor(SHAPE, idx, ent))
    want = ref.sketch_sparse(JST(SHAPE, idx, ent))
    for mu, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # salts and spec of every step: columns [0, nnz), never the rank slice
    for mu in range(3):
        spec = ours.side_spec(mu)
        assert spec == ("s", ours.true_rank[mu], ours.nnz[mu],
                        ours.rank_min[mu], ours.rank[mu])
        jspec, jsalts = JP.side_spec(ref, mu, (ref.seed + mu) % 2 ** 63)
        assert tuple(jspec) == spec
        ours_salts = ours.salts(mu).numpy().view(np.uint64)
        assert ours_salts.shape == (ours.nnz[mu],)  # no padding to 8 rows
        np.testing.assert_array_equal(
            ours_salts, np.asarray(jsalts)[: ours.nnz[mu]])


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_sign_drm_slice_equals_jax(pallas_interpret, transpose, dtype):
    # a rank block of the DRM is a slice of the full shuffle
    tdt, jdt, npdt = ((torch.float32, jnp.float32, np.float32)
                      if dtype == "f32"
                      else (torch.float64, jnp.float64, np.float64))
    idx, ent = _data(npdt)
    rank, lo, hi = (6, 8, 7), (1, 2, 0), (4, 7, 5)
    ours = SparseSignDRM(rank, SHAPE, transpose, seed=33, dtype=tdt)
    ref = JSS(rank, SHAPE, transpose, seed=33, dtype=jdt)
    full = ours.sketch_sparse(SparseTensor(SHAPE, idx, ent))
    part = ours.slice(lo, hi).sketch_sparse(SparseTensor(SHAPE, idx, ent))
    want = ref.slice(lo, hi).sketch_sparse(JST(SHAPE, idx, ent))
    for mu, (a, b) in enumerate(zip(part, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(),
                                      full[mu][lo[mu]:hi[mu]].numpy())


def test_sign_drm_nnz_order_follows_jax():
    # as in the JAX package, num_non_zero_per_row is stored as given: the
    # default is true_rank after the transpose reversal, an explicit tuple
    # is read in the DRM's own step order, and .T does not reverse it
    rank, nnz = (4, 6, 5), (2, 3, 1)
    for kw in (dict(), dict(num_non_zero_per_row=nnz)):
        for transpose in (False, True):
            ours = SparseSignDRM(rank, SHAPE, transpose, seed=1, **kw)
            ref = JSS(rank, SHAPE, transpose, seed=1, **kw)
            assert ours.nnz == tuple(ref.nnz)
            assert ours.T.nnz == tuple(ref.T.nnz) == ours.nnz
    right = SparseSignDRM(rank, SHAPE, True, seed=1)
    assert right.nnz == rank[::-1] == right.true_rank
    assert SparseSignDRM(rank, SHAPE, True, seed=1,
                         num_non_zero_per_row=nnz).nnz == nnz
    # what follows from it: the transpose of a DRM with unequal ranks holds
    # more non-zeros than slots at some step and cannot sketch (ROADMAP
    # Queue 3); no sketch path takes .T of a sign DRM
    idx, ent = _data(np.float64)
    assert right.T.true_rank == rank and right.T.nnz == rank[::-1]
    with pytest.raises(ValueError, match="non-zeros per row"):
        right.T.sketch_sparse(SparseTensor(SHAPE, idx, ent))[0]
    # slice drops an explicit value, as CanSlice does in the JAX package
    sliced = SparseSignDRM(rank, SHAPE, False, seed=1,
                           num_non_zero_per_row=nnz).slice((0, 0, 0), (2, 2, 2))
    assert sliced.nnz == rank


def test_hash_rows_from_pairs_serves_both_families():
    idx, _ = _data()
    flat = H.flat_index(torch.from_numpy(idx[:2]), SHAPE[:2])
    sign = SparseSignDRM(6, SHAPE, False, seed=2, dtype=torch.float32)
    gauss = SparseGaussianDRM(6, SHAPE, False, seed=2, dtype=torch.float32)
    rows = K._hash_rows_from_pairs(sign, 1, flat, torch.float32)
    assert set(np.unique(rows.numpy())) <= {-1.0, 0.0, 1.0}
    np.testing.assert_array_equal(
        rows.numpy(), SS.sparse_sign_rows(flat, sign.salts(1), 6, 6, 0,
                                          6).numpy())
    assert K._hash_rows_from_pairs(gauss, 1, flat, torch.float32).abs().max() > 1
    assert K.sparse_fused_applies(
        SparseTensor(SHAPE, *_data()), sign, gauss)
    f64 = SparseSignDRM(6, SHAPE, False, seed=2)
    assert not K.sparse_fused_applies(
        SparseTensor(SHAPE, *_data(np.float64)), f64, f64)


# -- sign and mixed side specs of the fused kernels --------------------------------

#: (rows out, spec or None for Gaussian); sliced sides shuffle over the
#: full rank and contract ``rows out`` of them
SIDES = {
    "g5": (5, None),
    "g7": (7, None),
    "s5": (5, ("s", 5, 5, 0, 5)),
    "s7few": (7, ("s", 7, 3, 0, 7)),
    "s4of9": (4, ("s", 9, 9, 3, 4)),
}


def _side(name, seed):
    """(rows, port spec, port salts, JAX spec, JAX salts) of a side."""
    r, spec = SIDES[name]
    if spec is None:
        return (r, ("g",), H.drm_salts(0, r, seed), ("g",),
                JR.drm_salts(0, r, seed))
    _, rank, nnz, rank_min, r_out = spec
    r_full = -(-max(rank, rank_min + -(-max(r_out, 1) // 8) * 8) // 8) * 8
    return (r, spec, H.drm_salts(0, nnz, seed), spec,
            JR.drm_salts(0, r_full, seed))


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


def _close(got, ref):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=PSI_REL * np.abs(ref).max())


@pytest.mark.parametrize("left,right", [
    ("s5", "s7few"), ("s5", "g7"), ("g5", "s7few"), ("s4of9", "s4of9"),
    (None, "s7few"), ("s4of9", None), (None, "s4of9"),
])
def test_psi_fused_slabs_sign_sides_match_pallas(jax_plan, left, right):
    _, _, jp = jax_plan
    p = _port_plan(jp)
    r1, lspec, tl, jlspec, jl = _side(left or "g5", 1)
    r2, rspec, tr, jrspec, jr = _side(right or "g7", 2)
    ref = np.asarray(JP.psi_fused_slabs(
        jp.local_idx, jp.sorted_entries, jp.flat_left if left else None,
        jp.flat_right if right else None, jl, jr, n_chunks=jp.n_chunks,
        span=jp.span, chunk=jp.chunk, interpret=True, lspec=jlspec,
        rspec=jrspec))
    got = SP.psi_fused_slabs(
        p.local_idx, p.sorted_entries, p.flat_left if left else None,
        p.flat_right if right else None, tl, tr, p.n_chunks, p.span,
        p.chunk, lspec, rspec)
    nc, S = jp.n_chunks, jp.span
    if left and right:
        ref = ref.reshape(nc, S, ref.shape[1] // S, -1)[:, :, :r1, :r2]
    elif right:
        ref = ref[:, :, :r2].reshape(nc, S, 1, r2)
    else:
        ref = ref[:, :, :r1].reshape(nc, S, r1, 1)
    _close(got, ref)


@pytest.mark.parametrize("left,right", [
    ("s5", "s7few"), ("s5", "g7"), ("g5", "s7few"), ("s4of9", "s4of9"),
])
def test_omega_fused_sign_sides_match_pallas(jax_plan, left, right):
    idx, ent, _ = jax_plan
    r1, lspec, tl, jlspec, jl = _side(left, 3)
    r2, rspec, tr, jrspec, jr = _side(right, 4)
    lflat = JH._flat_index_np(idx[:2], SHAPE[:2])
    rflat = JH._flat_index_np(idx[::-1][:2], SHAPE[::-1][:2])
    ref = JP.omega_fused(
        jnp.asarray(ent), JR.flat_u32_pairs(idx[:2], SHAPE[:2]),
        JR.flat_u32_pairs(idx[::-1][:2], SHAPE[::-1][:2]), jl, jr,
        interpret=True, lspec=jlspec, rspec=jrspec)
    got = SP.omega_fused(torch.from_numpy(ent), _i64(lflat), _i64(rflat),
                         tl, tr, lspec, rspec)
    _close(got, np.asarray(ref)[:r1, :r2])


@pytest.mark.parametrize("left,right,om", [
    ("s5", "s7few", "s4of9"), ("s5", "g7", "s5"), ("g5", "s7few", "g5"),
    (None, "s7few", "s5"), (None, "g7", "s4of9"),
])
def test_psi_omega_merged_sign_sides_match_pallas(jax_plan, left, right, om):
    _, _, jp = jax_plan
    p = _port_plan(jp)
    r1, lspec, tl, jlspec, jl = _side(left or "g5", 5)
    r2, rspec, tr, jrspec, jr = _side(right, 6)
    r1o, ospec, to, jospec, jo = _side(om, 7)
    slabs_ref, om_ref = JP.psi_omega_merged_slabs(
        jp.local_idx, jp.sorted_entries, jp.flat_left if left else None,
        jp.flat_right, jp.flat_left_om, jl, jr, jo, n_chunks=jp.n_chunks,
        span=jp.span, chunk=jp.chunk, interpret=True, lspec=jlspec,
        rspec=jrspec, ospec=jospec)
    slabs, omg = SP.psi_omega_merged_slabs(
        p.local_idx, p.sorted_entries, p.flat_left if left else None,
        p.flat_right, p.flat_left_om, tl, tr, to, p.n_chunks, p.span,
        p.chunk, lspec, rspec, ospec)
    nc, S = jp.n_chunks, jp.span
    slabs_ref = np.asarray(slabs_ref)
    if left:
        slabs_ref = slabs_ref.reshape(nc, S, -1, slabs_ref.shape[2])
        slabs_ref = slabs_ref[:, :, :r1, :r2]
    else:
        slabs_ref = slabs_ref[:, :, :r2].reshape(nc, S, 1, r2)
    _close(slabs, slabs_ref)
    _close(omg, np.asarray(om_ref)[:r1o, :r2])


# -- the slice as a whole ----------------------------------------------------------

PAIRS = {
    "sign_sign": (SparseSignDRM, SparseSignDRM, JSS, JSS),
    "sign_gauss": (SparseSignDRM, SparseGaussianDRM, JSS, JSG),
    "gauss_sign": (SparseGaussianDRM, SparseSignDRM, JSG, JSS),
}


def _tensors(idx, ent, threshold):
    ours, ref = SparseTensor(SHAPE, idx, ent), JST(SHAPE, idx, ent)
    if threshold is not None:
        ours = ours.with_psi_plan(threshold=threshold, chunk=128)
        ref = ref.with_psi_plan(indices=idx, entries=ent,
                                threshold=threshold, chunk=128)
    return ours, ref


@pytest.mark.parametrize("threshold", [12, 8, None])
@pytest.mark.parametrize("pair", PAIRS, ids=list(PAIRS))
def test_stream_sketch_sign_f32_matches_pallas(pallas_interpret, pair,
                                               threshold):
    # threshold 12 leaves modes 0 and 1 unplanned (row generators, Ω kernel,
    # merged and one-sided Ψ kernels all run), 8 plans every mode, None none
    lt, rt, jlt, jrt = PAIRS[pair]
    idx, ent = _data()
    t, jt = _tensors(idx, ent, threshold)
    kw = dict(left_rank=4, right_rank=8, seed=5)
    sk = stream_sketch(t, left_drm_type=lt, right_drm_type=rt,
                       dtype=torch.float32, **kw)
    jsk = jts.stream_sketch(jt, left_drm_type=jlt, right_drm_type=jrt,
                            dtype=jnp.float32, **kw)
    for a, b in zip(sk.Psi_cores + sk.Omega_mats,
                    jsk.Psi_cores + jsk.Omega_mats):
        _close(a, b)


@pytest.mark.parametrize("threshold", [8, None])
@pytest.mark.parametrize("pair", PAIRS, ids=list(PAIRS))
def test_stream_sketch_sign_f64_matches_jax(pair, threshold):
    lt, rt, jlt, jrt = PAIRS[pair]
    idx, ent = _data(np.float64)
    t, jt = _tensors(idx, ent, threshold)
    kw = dict(left_rank=4, right_rank=8, seed=5)
    sk = stream_sketch(t, left_drm_type=lt, right_drm_type=rt, **kw)
    jsk = jts.stream_sketch(jt, left_drm_type=jlt, right_drm_type=jrt, **kw)
    for a, b in zip(sk.Psi_cores + sk.Omega_mats,
                    jsk.Psi_cores + jsk.Omega_mats):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)


def test_sign_sketch_takes_the_sign_generator_and_the_fused_kernels(
        monkeypatch):
    # on CPU tensors the wrappers run their plain versions: count calls
    idx, ent = _data()
    t = SparseTensor(SHAPE, idx, ent).with_psi_plan(threshold=12, chunk=128)
    calls = {}
    for mod, name in [(SS, "sparse_sign_rows_reference"),
                      (LG, "lazy_gaussian_reference"),
                      (SP, "lazy_gaussian_reference"),
                      (SP, "omega_fused_reference"),
                      (SP, "psi_omega_merged_slabs_reference")]:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    before = _launches("sparse_sign_rows")
    stream_sketch(t, 4, 8, seed=1, left_drm_type=SparseSignDRM,
                  right_drm_type=SparseSignDRM, dtype=torch.float32)
    # 3 materialized row blocks of the unplanned modes through the wrapper
    # sparse_sign_rows (the fused plain versions call the row reference by
    # another name and are not counted here); no Gaussian row anywhere
    assert calls["sparse_sign_rows_reference"] == 3
    assert "lazy_gaussian_reference" not in calls
    assert calls["omega_fused_reference"] == 3
    assert calls["psi_omega_merged_slabs_reference"] == 1
    assert _launches("sparse_sign_rows") == before
