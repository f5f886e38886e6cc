"""The sparse chain step and the Ψ kernels over given rows of the port
against the JAX package.

Reference side: the JAX functions on the same numpy data; float32 runs the
Pallas kernels in interpret mode (``chain_step_t(..., interpret=True)``,
and ``TT_SKETCH_TPU_FORCE_TPU=1``/``TT_SKETCH_TPU_PALLAS_INTERPRET=1`` for
the Ψ functions, as the JAX package's own tests do).  The port runs its
plain versions (CPU tensors).  Tolerances, with their reasons:

- float64 chain steps and TT-DRM rows: 1e-13 absolute (the same summands of
  O(1) values, summed by two einsums);
- float32 chain steps against the one-hot Pallas kernel: ``4e-7·max|ref|``
  per step (sums of at most 9 float32 products in another order);
  float32 TT-DRM rows after three steps: ``2e-6·max|ref|``;
- float32 Ψ after the slab combine: ``3e-5·max|ref|`` (float32 sums over
  up to 128 nonzeros in another order, as ``tests/test_sparse_plan.py``
  holds fused against plain).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_sketch_torch import config, profiling
from tt_sketch_torch.drm import (
    SparseGaussianDRM,
    SparseSignDRM,
    TensorTrainDRM,
)
from tt_sketch_torch.drm import tensor_train_drm as TD
from tt_sketch_torch.formats import SparseTensor
from tt_sketch_torch.interop import tt_drm_from_numpy
from tt_sketch_torch.kernels import chain_step as CS
from tt_sketch_torch.kernels import sketch_kernels as K
from tt_sketch_torch.kernels import sparse_psi as SP
from tt_sketch_tpu.drm import SparseGaussianDRM as JSG
from tt_sketch_tpu.drm import SparseSignDRM as JSS
from tt_sketch_tpu.drm import TensorTrainDRM as JTT
from tt_sketch_tpu.drm import tensor_train_drm as JTD
from tt_sketch_tpu.formats import SparseTensor as JST
from tt_sketch_tpu.kernels import pallas_chain as JC
from tt_sketch_tpu.kernels import sketch_kernels as JK

SHAPE = (11, 9, 30, 25)
NNZ = 1200
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


def _data(dtype=np.float32, seed=31):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, NNZ) for s in SHAPE]).astype(np.int64)
    ent = rng.standard_normal(NNZ).astype(dtype)
    return idx, ent


def _pair(idx, ent, threshold=8):
    ours = SparseTensor(SHAPE, idx, ent).with_psi_plan(
        threshold=threshold, chunk=128)
    ref = JST(SHAPE, idx, ent).with_psi_plan(
        indices=idx, entries=ent, threshold=threshold, chunk=128)
    return ours, ref


def _step_operands(r1, n, r2, nnz, dtype, seed=0):
    rng = np.random.default_rng(seed)
    core = rng.standard_normal((r1, n, r2)).astype(dtype)
    state = rng.standard_normal((r1, nnz)).astype(dtype)
    idx = rng.integers(0, n, nnz).astype(np.int64)
    idx[:2] = (n - 1, 0)
    return state, core, idx


def _close(got, ref, rel):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


# -- the chain step ------------------------------------------------------------

@pytest.mark.parametrize("first", [False, True], ids=["step", "first"])
@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "t"])
def test_chain_step_sparse_f64_matches_jax(first, transposed):
    r1 = 1 if first else 5
    state_t, core, idx = _step_operands(r1, 30, 7, NNZ, np.float64)
    if transposed:
        ref = JTD.chain_step_sparse_t(
            None if first else jnp.asarray(state_t), jnp.asarray(core),
            jnp.asarray(idx))
        got = TD.chain_step_sparse_t(
            None if first else torch.from_numpy(state_t),
            torch.from_numpy(core), torch.from_numpy(idx))
        assert tuple(got.shape) == (7, NNZ)
    else:
        ref = JTD.chain_step_sparse(
            None if first else jnp.asarray(state_t.T), jnp.asarray(core),
            jnp.asarray(idx))
        got = TD.chain_step_sparse(
            None if first else torch.from_numpy(state_t.T.copy()),
            torch.from_numpy(core), torch.from_numpy(idx))
        assert tuple(got.shape) == (NNZ, 7)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("r1,n,r2,nnz", [
    (5, 30, 7, 1200),    # odd ranks, ragged nnz
    (1, 9, 4, 700),      # the first step: no state
    (1, 1, 1, 300),      # n = 1, ranks of 1, with a state
    (9, 200, 3, 5000),   # several of the one-hot kernel's chunks
    (4, 130, 8, 4096),   # a mode just past one 128-row tile
])
def test_chain_step_t_f32_matches_pallas_interpret(r1, n, r2, nnz):
    state_t, core, idx = _step_operands(r1, n, r2, nnz, np.float32, seed=nnz)
    first = r1 == 1 and n == 9
    ref = JC.chain_step_t(
        None if first else jnp.asarray(state_t), jnp.asarray(core),
        jnp.asarray(idx.astype(np.int32)), interpret=True)
    got = CS.chain_step_t(
        None if first else torch.from_numpy(state_t), torch.from_numpy(core),
        torch.from_numpy(idx))
    assert got.dtype == torch.float32
    _close(got, ref, 4e-7)
    if first:
        # a gather: exact
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype,n,nnz,rank,kernel", [
    (torch.float32, 5000, 64, 3, True),    # the JAX gate: n <= 4096
    (torch.float32, 30, 100, 3, True),     # the JAX gate: nnz >= 4096
    (torch.float32, 30, 5000, 40, True),   # no rank cap
    (torch.bfloat16, 30, 100, 3, True),
    (torch.float64, 30, 5000, 3, False),   # the parity path: plain einsum
])
def test_chain_step_has_no_size_gate(monkeypatch, dtype, n, nnz, rank, kernel):
    """float32/bfloat16 always go to the ``chain_step_t`` wrapper, whatever
    the mode size, the number of nonzeros or the rank; float64 never."""
    calls = []
    wrapper = CS.chain_step_t

    def counting(*args):
        calls.append(args)
        return wrapper(*args)

    monkeypatch.setattr(TD, "chain_step_t", counting)
    g = torch.Generator().manual_seed(1)
    core = torch.randn((rank, n, rank), generator=g).to(dtype)
    state = torch.randn((rank, nnz), generator=g).to(dtype)
    idx = torch.randint(0, n, (nnz,), generator=g)
    out = TD.chain_step_sparse_t(state, core, idx)
    assert out.dtype == dtype and tuple(out.shape) == (rank, nnz)
    assert len(calls) == (1 if kernel else 0)
    ref = torch.einsum("ijk,ij->kj", core.double()[:, idx, :], state.double())
    tol = {torch.float64: 1e-13, torch.float32: 1e-5,
           torch.bfloat16: 2e-2}[dtype]
    assert float((out.double() - ref).abs().max()) <= tol * float(
        ref.abs().max())


def test_chain_step_t_checks_its_operands():
    state_t, core, idx = (torch.from_numpy(a) for a in
                          _step_operands(5, 30, 7, 100, np.float32))
    with pytest.raises(ValueError, match="r1 == 1"):
        CS.chain_step_t(None, core, idx)
    with pytest.raises(ValueError, match="state of shape"):
        CS.chain_step_t(state_t[:, :-1], core, idx)
    with pytest.raises(ValueError, match="state of shape"):
        CS.chain_step_t(state_t.T, core, idx)
    # a tensor that is neither on the CPU nor on a card does not fall back
    # to the plain version
    with pytest.raises(ValueError, match="CUDA"):
        CS.chain_step_t(state_t.to("meta"), core.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        CS.chain_step_t(state_t, core.to("meta"), idx)
    assert CS.chain_step_t(state_t[:, :0], core, idx[:0]).shape == (7, 0)
    before = _launches("chain_step_t")
    CS.chain_step_t(state_t, core, idx)
    assert _launches("chain_step_t") == before  # CPU: the plain version


# -- TensorTrainDRM.sketch_sparse ----------------------------------------------

@pytest.mark.parametrize("transpose", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_tt_drm_sketch_sparse_matches_jax(pallas_interpret, transpose, dtype):
    np_dt, jdt = ((np.float64, jnp.float64) if dtype == "f64"
                  else (np.float32, jnp.float32))
    idx, ent = _data(np_dt)
    t, jt = SparseTensor(SHAPE, idx, ent), JST(SHAPE, idx, ent)
    rank = (4, 6, 5)
    jdrm = JTT(rank, SHAPE, transpose, seed=12, dtype=jdt)
    drm = tt_drm_from_numpy([np.asarray(c) for c in jdrm.cores], rank, SHAPE,
                            transpose, seed=12)
    assert isinstance(drm, TensorTrainDRM)
    assert drm.rank == tuple(jdrm.rank) and drm.transpose == transpose
    assert drm.cores[0].dtype == (torch.float64 if dtype == "f64"
                                  else torch.float32)
    ref = jdrm.sketch_sparse(jt)
    got = drm.sketch_sparse(t)
    assert len(got) == len(ref) == len(SHAPE) - 1
    for a, b in zip(got, ref):
        assert tuple(a.shape) == tuple(b.shape)
        if dtype == "f64":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-13)
        else:
            _close(a, b, 2e-6)


def test_tt_drm_from_numpy_carries_a_rank_slice():
    idx, ent = _data(np.float64)
    t, jt = SparseTensor(SHAPE, idx, ent), JST(SHAPE, idx, ent)
    full = JTT((6, 6, 6), SHAPE, True, seed=3)
    jdrm = full.slice((2, 1, 0), (5, 6, 4))
    kw = dict(rank_min=jdrm.rank_min[::-1], rank_max=jdrm.rank_max[::-1],
              true_rank=jdrm.true_rank[::-1])
    drm = tt_drm_from_numpy([np.asarray(c) for c in jdrm.cores], (6, 6, 6),
                            SHAPE, True, **kw)
    assert drm.rank == tuple(jdrm.rank)
    for a, b in zip(drm.sketch_sparse(t), jdrm.sketch_sparse(jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-13)


# -- Ψ over given rows: psi_chunk_slabs ----------------------------------------

def _given_rows(r, seed):
    return np.random.default_rng(seed).standard_normal((r, NNZ)).astype(
        np.float32)


@pytest.mark.parametrize("variant", ["both", "noright", "noleft"])
@pytest.mark.parametrize("mu", [2, 3])
def test_psi_chunk_slabs_matches_pallas(pallas_interpret, variant, mu):
    """Ψ_μ through the grouped path, after the slab combine: the port's
    plain ``psi_chunk_slabs`` against the Pallas kernel (both variants; a
    missing left side is a row of ones in both packages)."""
    idx, ent = _data()
    t, jt = _pair(idx, ent)
    left = None if variant == "noleft" else _given_rows(5, 1)
    right = None if variant == "noright" else _given_rows(7, 2)
    ref = JK._psi_sparse_grouped(
        None if left is None else jnp.asarray(left),
        None if right is None else jnp.asarray(right),
        jt.entries, jt.psi_plan[mu], SHAPE[mu])
    got = K._psi_sparse_grouped(
        None if left is None else torch.from_numpy(left),
        None if right is None else torch.from_numpy(right),
        t.entries, t.psi_plan[mu], SHAPE[mu])
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (1 if left is None else 5, SHAPE[mu],
                                1 if right is None else 7)
    _close(got, ref, PSI_REL)


def test_psi_chunk_slabs_raw_slabs_match_pallas():
    """The slabs themselves, before the combine, in the port's unpadded
    layout ``(n_chunks, span, r1, r2)``."""
    from tt_sketch_tpu.kernels.pallas_psi import psi_chunk_slabs as j_slabs

    idx, ent = _data()
    t, jt = _pair(idx, ent)
    p, jp = t.psi_plan[2], jt.psi_plan[2]
    sl, sr = _given_rows(5, 3), _given_rows(7, 4)
    nc, S, C = jp.n_chunks, jp.span, jp.chunk
    pad = ((0, 0), (0, nc * C - NNZ))
    ref = j_slabs(jp.local_idx, jnp.pad(jp.sorted_entries, pad[1]),
                  jnp.pad(jnp.asarray(sl), pad), jnp.pad(jnp.asarray(sr), pad),
                  n_chunks=nc, span=S, chunk=C, interpret=True)
    got = SP.psi_chunk_slabs(p.local_idx, p.sorted_entries,
                             torch.from_numpy(sl), torch.from_numpy(sr),
                             p.n_chunks, p.span, p.chunk)
    _close(got, np.asarray(ref).reshape(nc, S, 5, 7), PSI_REL)
    ref1 = j_slabs(jp.local_idx, jnp.pad(jp.sorted_entries, pad[1]),
                   jnp.pad(jnp.asarray(sl), pad), None,
                   n_chunks=nc, span=S, chunk=C, interpret=True)
    got1 = SP.psi_chunk_slabs(p.local_idx, p.sorted_entries,
                              torch.from_numpy(sl), None, p.n_chunks, p.span,
                              p.chunk)
    _close(got1, np.asarray(ref1).reshape(nc, S, 5, 1), PSI_REL)


def test_grouped_psi_reads_the_entries_it_is_given():
    """``_psi_sparse_grouped`` gathers its ``entries`` argument through the
    plan's permutation and never reads ``plan.sorted_entries`` (the JAX
    package prefers the plan's copy): a plan whose copy went stale cannot
    change Ψ.  ``SparseTensor`` operations that change the entries rebuild
    the plan's copy, so both agree wherever a tensor carries its plan."""
    idx, ent = _data()
    t = SparseTensor(SHAPE, idx, ent).with_psi_plan(threshold=8, chunk=128)
    left = torch.from_numpy(_given_rows(5, 5))
    p = t.psi_plan[3]
    good = K._psi_sparse_grouped(left, None, t.entries, p, SHAPE[3])
    stale = p._replace(sorted_entries=p.sorted_entries * 0 + 7)
    again = K._psi_sparse_grouped(left, None, t.entries, stale, SHAPE[3])
    assert torch.equal(good, again)
    scaled = t * 3.0
    torch.testing.assert_close(
        scaled.psi_plan[3].sorted_entries,
        scaled.entries[scaled.psi_plan[3].perm])
    tripled = K._psi_sparse_grouped(left, None, scaled.entries,
                                    scaled.psi_plan[3], SHAPE[3])
    # 3·e rounds before the sums: float32 sums of other summands
    _close(tripled, (3.0 * good).numpy(), PSI_REL)


# -- Ψ with one hashed side: psi_chunk_slabs_genright --------------------------

def _hash_drms(kind, rank, transpose, seed):
    if kind == "gauss":
        return (SparseGaussianDRM(rank, SHAPE, transpose, seed=seed,
                                  dtype=torch.float32),
                JSG(rank, SHAPE, transpose, seed=seed, dtype=jnp.float32))
    nnz = {"sign": None, "signfew": (2, 2, 2)}[kind]
    return (SparseSignDRM(rank, SHAPE, transpose, seed=seed,
                          num_non_zero_per_row=nnz, dtype=torch.float32),
            JSS(rank, SHAPE, transpose, seed=seed, num_non_zero_per_row=nnz,
                dtype=jnp.float32))


@pytest.mark.parametrize("kind", ["gauss", "sign", "signfew"])
@pytest.mark.parametrize("hashed,mu", [("right", 2), ("left", 2), ("left", 3)])
def test_psi_chunk_slabs_genright_matches_pallas(pallas_interpret, kind,
                                                 hashed, mu):
    """Ψ_μ through the half-fused path, after the slab combine, in both
    orientations: hashed right rows with given left rows, and the swapped
    call (hashed left, given right, blocks transposed).  The last mode
    consumes no right DRM: there the hashed side is the left one and the
    given side is absent."""
    d = len(SHAPE)
    idx, ent = _data()
    t, jt = _pair(idx, ent)
    given = _given_rows(5, 6)
    drm, jdrm = _hash_drms(kind, 7, hashed == "right", seed=21)
    if hashed == "right":
        args = dict(left_drm=None, right_drm=drm)
        jargs = dict(left_drm=None, right_drm=jdrm)
        sides, r_shape = (given, None), (5, SHAPE[mu], 7)
    else:
        args = dict(left_drm=drm, right_drm=None)
        jargs = dict(left_drm=jdrm, right_drm=None)
        last = mu == d - 1
        sides = (None, None if last else given)
        r_shape = (7, SHAPE[mu], 1 if last else 5)
    ref = JK._psi_sparse_halffused(
        *(None if s is None else jnp.asarray(s) for s in sides), jt, mu,
        jt.psi_plan[mu], SHAPE[mu], **jargs)
    assert K._can_halffuse_psi(
        t.psi_plan[mu], t, mu,
        *(None if s is None else torch.from_numpy(s) for s in sides), **args)
    got = K._psi_sparse_halffused(
        *(None if s is None else torch.from_numpy(s) for s in sides), t, mu,
        t.psi_plan[mu], SHAPE[mu], **args)
    assert tuple(got.shape) == r_shape and got.dtype == torch.float32
    _close(got, ref, PSI_REL)


def test_genright_side_may_be_a_thunk():
    idx, ent = _data()
    t, _ = _pair(idx, ent)
    given = torch.from_numpy(_given_rows(5, 7))
    drm, _ = _hash_drms("gauss", 7, True, seed=2)
    direct = K._psi_sparse_halffused(given, None, t, 2, t.psi_plan[2],
                                     SHAPE[2], None, drm)
    lazy = K._psi_sparse_halffused(lambda: given, None, t, 2, t.psi_plan[2],
                                   SHAPE[2], None, drm)
    assert torch.equal(direct, lazy)


# -- operand checks and the shared-memory limit --------------------------------

def test_slab_kernels_check_their_rows():
    idx, ent = _data()
    t, _ = _pair(idx, ent)
    p = t.psi_plan[2]
    geom = (p.n_chunks, p.span, p.chunk)
    rows = torch.from_numpy(_given_rows(5, 8))
    with pytest.raises(ValueError, match="left or a right side"):
        SP.psi_chunk_slabs(p.local_idx, p.sorted_entries, None, None, *geom)
    padded = torch.nn.functional.pad(rows, (0, p.n_chunks * p.chunk - NNZ))
    with pytest.raises(ValueError, match="unpadded"):
        SP.psi_chunk_slabs(p.local_idx, p.sorted_entries, padded, None, *geom)
    with pytest.raises(ValueError, match="unpadded"):
        SP.psi_chunk_slabs_genright(
            p.local_idx, p.sorted_entries, rows.T, p.flat_right,
            torch.zeros(7, dtype=torch.int64), *geom)
    with pytest.raises(ValueError, match="flat indices"):
        SP.psi_chunk_slabs_genright(
            p.local_idx, p.sorted_entries, rows, None,
            torch.zeros(7, dtype=torch.int64), *geom)
    with pytest.raises(ValueError, match="spec"):
        SP.psi_chunk_slabs_genright(
            p.local_idx, p.sorted_entries, rows, p.flat_right,
            torch.zeros(7, dtype=torch.int64), *geom, ("x",))
    before = (_launches("psi_chunk_slabs"),
              _launches("psi_chunk_slabs_genright"))
    SP.psi_chunk_slabs(p.local_idx, p.sorted_entries, rows, None, *geom)
    assert before == (_launches("psi_chunk_slabs"),
                      _launches("psi_chunk_slabs_genright"))


def test_given_sides_count_against_the_shared_memory_limit():
    """A block keeps every side's rows of a 64-nnz tile in its 232,448
    bytes of shared memory, 260 bytes a row: given sides hold 892 + 1 rows
    at most (no salts), 893 + 1 raise; a given side beside a sign side
    shares the sign sides' limit of 866 rows with a salt each."""
    flat = torch.zeros(4, dtype=torch.int64)
    rows = torch.zeros((4, 4))
    given, gauss = SP._GIVEN, SP._GAUSS
    SP._check_shared_memory("psi_chunk_slabs", (rows, given, 892),
                            (rows, given, 1))
    with pytest.raises(ValueError, match="232448"):
        SP._check_shared_memory("psi_chunk_slabs", (rows, given, 893),
                                (rows, given, 1))
    # a missing side is one row of ones
    SP._check_shared_memory("psi_chunk_slabs", (rows, given, 892),
                            (None, gauss, 1))
    with pytest.raises(ValueError, match="shared memory"):
        SP._check_shared_memory("psi_chunk_slabs", (rows, given, 893),
                                (None, gauss, 1))
    # given 433 rows + a sign side of rank 446 with a salt per slot:
    # 8·446 + 260·879 + 256 = 232,364 bytes fit, one more slot does not
    SP._check_shared_memory(
        "psi_chunk_slabs_genright", (rows, given, 433),
        (flat, ("s", 446, 446, 0, 10), 10))
    with pytest.raises(ValueError, match="psi_chunk_slabs_genright"):
        SP._check_shared_memory(
            "psi_chunk_slabs_genright", (rows, given, 433),
            (flat, ("s", 447, 447, 0, 10), 10))
    # Gaussian right side: r rows and r salts, 8·433 + 260·879 + 256 bytes
    SP._check_shared_memory("psi_chunk_slabs_genright", (rows, given, 446),
                            (flat, gauss, 433))
    with pytest.raises(ValueError, match="shared memory"):
        SP._check_shared_memory("psi_chunk_slabs_genright",
                                (rows, given, 447), (flat, gauss, 433))
