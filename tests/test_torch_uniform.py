"""The uniform-TT engine of ``tt_sketch_torch`` (``engine/uniform.py``)
against ``tt_sketch_tpu``'s on the CPU, and the batched ``_lstsq`` it
solves with.

Inputs are made from seeds: the exp-decay test tensor with numpy (the same
cores in both packages), random TTs with the JAX package's PRNG carried
across as numpy.  QR and SVD signs are each library's choice, so the
sketches' recovered TTs are compared as tensors (``uniform_rel_error`` on
the exact route, or dense), never core by core.  Tolerances, with their
reasons:

- ``uniform_exp_decay_tt``, stack/unstack, the hash stream's counters and
  uniforms: exact;
- hash-stream normals against the JAX package's: 1e-15 absolute and
  relative (XLA's CPU ``ndtri`` contracts its polynomials into FMAs and has
  its own ``log``; ``torch.special.ndtri`` differs in the last bit of
  about 70 % of the draws);
- Ψ/Ω from the same cores: 1e-12 relative (float64 einsums in another
  order);
- recovered and rounded tensors, dot, norm, add, errors: 1e-10 relative
  (float64 QRs, SVDs and pseudo-inverses in another library);
- the order-scaling rows: 1e-8 relative, plus 1e-13 absolute for rows whose
  error is at roundoff (rounding to 3 of a spectrum that falls 1e-5 per
  rank leaves about 1e-14);
- the Gram route against the exact one: 1e-6 relative at an error of about
  3e-2 (the Gram identity keeps about sqrt(eps) of ‖B‖).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_sketch_torch.engine.uniform as TU
from tt_sketch_torch import config
from tt_sketch_torch.drm import TensorTrainDRM
from tt_sketch_torch.engine.dispatch import SketchMethod, general_sketch
from tt_sketch_torch.formats import TensorTrain
from tt_sketch_torch.rng import hash_rng as TH
from tt_sketch_torch.utils import _lstsq, right_mul_pinv
from tt_sketch_tpu.engine import uniform as JU
from tt_sketch_tpu.experiments import tasks as jtasks
from tt_sketch_tpu.rng import hash_rng as JH

REC_TOL = 1e-10
PSI_TOL = 1e-12
HASH_TOL = 1e-15
ROW_TOL, ROW_FLOOR = 1e-8, 1e-13
GRAM_TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _t(stacked):
    """A JAX stacked TT as torch tensors."""
    return tuple(torch.from_numpy(np.array(x)) for x in stacked)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _seed_for(rank, run, extra=0):
    """``tt_sketch_tpu/experiments/drivers.py``'s seed rule."""
    return 100_003 * run + 1009 * rank + extra


# -- the batched least-squares solve -----------------------------------------

def _lstsq_2d(A, B, rcond=None):
    """``_lstsq`` as it was before it took batch dimensions."""
    m, n = A.shape
    if rcond is None:
        rcond = torch.finfo(A.dtype).eps * max(m, n)
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    keep = s >= rcond * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return Vh.mT @ (s_inv[:, None] * (U.mT @ B))


def _lstsq_cases(batch=(), seed=0):
    g = torch.Generator().manual_seed(seed)
    full = torch.randn(batch + (12, 7), generator=g, dtype=torch.float64)
    # rank-deficient: 4 of 7 columns
    low = (torch.randn(batch + (12, 4), generator=g, dtype=torch.float64)
           @ torch.randn(batch + (4, 7), generator=g, dtype=torch.float64))
    B = torch.randn(batch + (12, 5), generator=g, dtype=torch.float64)
    return [(full, B), (low, B), (full.mT[..., :5, :].contiguous(),
                                  B[..., :5, :])]


@pytest.mark.parametrize("case", range(3))
def test_lstsq_2d_bits_unchanged(case):
    A, B = _lstsq_cases()[case]
    assert torch.equal(_lstsq(A, B), _lstsq_2d(A, B))
    assert torch.equal(_lstsq(A, B, rcond=1e-3), _lstsq_2d(A, B, rcond=1e-3))


@pytest.mark.parametrize("case", range(3))
def test_lstsq_batched_equals_loop(case):
    A, B = _lstsq_cases(batch=(3, 2), seed=1)[case]
    got = _lstsq(A, B)
    for i in range(3):
        for j in range(2):
            np.testing.assert_allclose(got[i, j].numpy(),
                                       _lstsq_2d(A[i, j], B[i, j]).numpy(),
                                       rtol=0, atol=1e-14)
    # right_mul_pinv over a batch: A @ pinv(B) per matrix
    Ps = torch.randn(4, 9, 6, dtype=torch.float64)
    Om = torch.randn(4, 3, 6, dtype=torch.float64)
    batched = right_mul_pinv(Ps, Om)
    for i in range(4):
        np.testing.assert_allclose(batched[i].numpy(),
                                   right_mul_pinv(Ps[i], Om[i]).numpy(),
                                   rtol=0, atol=1e-14)


# -- representation and generation ------------------------------------------

def test_stack_roundtrip_and_uniformity():
    st = TU.uniform_random_tt(6, 4, 3, seed=0)
    tt = TU.unstack_tt(*st)
    assert TU.is_uniform(tt) and len(tt.cores) == 6
    again = TU.stack_tt(tt)
    for a, b in zip(st, again):
        assert torch.equal(a, b)
    for a, b in zip(tt.cores, TU.unstack_tt(*again).cores):
        assert torch.equal(a, b)
    short = TensorTrain.random((4, 4), 2, seed=0)
    assert not TU.is_uniform(short)
    with pytest.raises(ValueError, match="d >= 3"):
        TU.stack_tt(short)
    ragged = TensorTrain.random((4, 5, 4, 4), 2, seed=0)
    assert not TU.is_uniform(ragged)
    with pytest.raises(ValueError, match="not uniform"):
        TU.stack_tt(ragged)


@pytest.mark.parametrize("d,n,rank,seed", [(7, 6, 5, 12345),
                                           (4, 3, 1, 2 ** 40 + 7)])
def test_hash_stream_counters_and_values(d, n, rank, seed):
    """The rows of first, interior and last sit at the JAX package's global
    counters: the port's draws equal ``ndtri`` of the JAX package's hashed
    uniforms bit for bit, and its normals equal the JAX package's to the
    last bits of ``ndtri``."""
    n_int = (d - 2) * rank * n
    pieces = ((0, n, rank), (n, n_int, rank), (n + n_int, rank * n, 1))
    for start, count, cols in pieces:
        ids = jnp.arange(start, start + count, dtype=jnp.uint64)
        bits = np.array(JH._hash_bits(ids, 0, cols, seed)).view(np.int64)
        u = TH.uniform_from_bits(torch.from_numpy(bits))
        ref_u = np.array(JH.uniform_from_bits(jnp.asarray(bits.view(
            np.uint64))))
        assert np.array_equal(u.numpy(), ref_u)
        got = TU._hash_normal_rows(start, count, cols, seed,
                                   torch.float64, "cpu")
        assert torch.equal(got, torch.special.ndtri(u))
    for goal in ("norm-1", "norm-preserve"):
        ours = TU.uniform_random_tt(d, n, rank, seed, norm_goal=goal,
                                    stream="hash")
        ref = JU.uniform_random_tt(d, n, rank, seed, norm_goal=goal,
                                   stream="hash")
        for a, b in zip(ours, ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=HASH_TOL, atol=HASH_TOL)


def test_hash_stream_chunks_keep_the_counters(monkeypatch):
    whole = TU.uniform_random_tt(6, 5, 4, 9, stream="hash")
    monkeypatch.setattr(TU, "HASH_CHUNK", 7)
    for a, b in zip(TU.uniform_random_tt(6, 5, 4, 9, stream="hash"), whole):
        assert torch.equal(a, b)


def test_torch_stream_is_deterministic_and_jax_stream_raises():
    a = TU.uniform_random_tt(5, 4, 3, seed=3)
    b = TU.uniform_random_tt(5, 4, 3, seed=3, stream="torch")
    c = TU.uniform_random_tt(5, 4, 3, seed=4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert [tuple(x.shape) for x in a] == [(1, 4, 3), (3, 3, 4, 3), (3, 4, 1)]
    with pytest.raises(ValueError, match="'torch'.*'hash'"):
        TU.uniform_random_tt(5, 4, 3, seed=3, stream="jax")
    tt = TU.unstack_tt(*a)
    with pytest.raises(ValueError, match="'torch'.*'hash'"):
        TU.uniform_stream_sketch(tt, 2, 4, seed=1, drm_stream="jax")
    with pytest.raises(ValueError, match="unknown stream"):
        TU.uniform_random_tt(5, 4, 3, seed=3, stream="numpy")
    with pytest.raises(ValueError):
        TU.uniform_random_tt(5, 4, 3, seed=3, norm_goal="norm-2")


@pytest.mark.parametrize("d,n,rank,seed,min_svdval",
                         [(6, 5, 4, 10, -6.0), (9, 6, 5, 179, -20.0)])
def test_exp_decay_bits(d, n, rank, seed, min_svdval):
    ours = TU.uniform_exp_decay_tt(d, n, rank, seed, min_svdval=min_svdval)
    ref = JU.uniform_exp_decay_tt(d, n, rank, seed, min_svdval=min_svdval)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float64
        assert torch.equal(a, torch.from_numpy(np.array(b)))


def test_no_card_means_an_error_for_the_uniform_entry_points(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.set_default_device("cuda")
    for make in (lambda: TU.uniform_random_tt(5, 4, 3, seed=0),
                 lambda: TU.uniform_random_tt(5, 4, 3, seed=0,
                                              stream="hash"),
                 lambda: TU.uniform_exp_decay_tt(5, 4, 3, seed=0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    st = TU.uniform_exp_decay_tt(5, 4, 3, seed=0, device="cpu")
    assert st[1].device.type == "cpu"
    # functions of tensors work where the tensors lie
    rec, _ = TU.uniform_stream_sketch(TU.unstack_tt(*st), 3, 6, seed=1)
    assert rec.device.type == "cpu"


# -- sketches ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_cores():
    """X, Y, Z from the JAX package's PRNG (d = 6, n = 5)."""
    X = JU.uniform_random_tt(6, 5, 3, seed=1)
    Y = JU.uniform_random_tt(6, 5, 4, seed=2, norm_goal="norm-preserve")
    Z = JU.uniform_random_tt(6, 5, 7, seed=3, norm_goal="norm-preserve")
    return X, Y[:2], Z[:2]


def test_stream_sketch_stacked_against_jax(jax_cores):
    X, Y, Z = jax_cores
    (Pf, Pi, Pl), Om = TU.uniform_stream_sketch_stacked(_t(X), _t(Y), _t(Z))
    (Jf, Ji, Jl), JOm = JU.uniform_stream_sketch_stacked(X, Y, Z)
    for a, b in ((Pf, Jf), (Pi, Ji), (Pl, Jl), (Om, JOm)):
        assert tuple(a.shape) == b.shape
        assert _rel(a.numpy(), b) <= PSI_TOL


@pytest.mark.parametrize("direction", ["right", "left"])
def test_assemble_against_jax(jax_cores, direction):
    X, Y, Z = jax_cores
    if direction == "left":
        Y, Z = Z, Y   # the left side has the bigger rank
    psis, om = JU.uniform_stream_sketch_stacked(X, Y, Z)
    ref = JU.unstack_tt(*JU.uniform_assemble(psis, om, direction))
    ours = TU.unstack_tt(*TU.uniform_assemble(_t(psis), torch.from_numpy(
        np.array(om)), direction))
    assert _rel(ours.to_dense().numpy(), ref.to_dense()) <= REC_TOL
    # the recovery is exact: rank 3 under sketch ranks 4/7
    assert _rel(ours.to_dense().numpy(),
                JU.unstack_tt(*X).to_dense()) <= 1e-9
    with pytest.raises(ValueError):
        TU.uniform_assemble(_t(psis), torch.from_numpy(np.array(om)), "up")


def test_container_matches_generic_engine():
    """With the cores of two ``TensorTrainDRM``s, the uniform Ψ/Ω equal the
    generic engine's streaming sketch."""
    d, n = 6, 5
    shape = (n,) * d
    tt = TensorTrain.random(shape, 3, seed=0)
    left = TensorTrainDRM(4, shape=shape, transpose=False, seed=21)
    right = TensorTrainDRM(7, shape=shape, transpose=True, seed=22)
    ref = general_sketch(tt, left, right, SketchMethod.streaming)
    (Pf, Pi, Pl), Om = TU.uniform_stream_sketch_stacked(
        TU.stack_tt(tt), (left.cores[0], torch.stack(left.cores[1:])),
        (right.cores[0], torch.stack(right.cores[1:])))
    psis = [Pf] + list(Pi) + [Pl]
    for a, b in zip(ref.Psi_cores, psis):
        assert _rel(a.numpy(), b.numpy()) <= PSI_TOL
    for a, b in zip(ref.Omega_mats, Om):
        assert _rel(a.numpy(), b.numpy()) <= PSI_TOL


@pytest.fixture(scope="module")
def decay():
    return JU.uniform_exp_decay_tt(8, 6, 5, seed=3)


SKETCHES = {
    "stta": (lambda m, tt: m.uniform_stream_sketch(
        tt, 5, 10, seed=7, drm_stream="hash")[0]),
    "stta-left": (lambda m, tt: m.uniform_stream_sketch(
        tt, 10, 5, seed=7, drm_stream="hash")[0]),
    "hmt": (lambda m, tt: m.uniform_hmt_sketch(tt, 5, seed=8,
                                               drm_stream="hash")),
    "otts": (lambda m, tt: m.uniform_orthogonal_sketch(
        tt, 4, 10, seed=9, drm_stream="hash")),
}


@pytest.mark.parametrize("method", sorted(SKETCHES))
def test_sketches_against_jax(decay, method):
    X = _t(decay)
    ours = SKETCHES[method](TU, TU.unstack_tt(*X))
    ref = SKETCHES[method](JU, JU.unstack_tt(*decay))
    assert [tuple(c.shape) for c in ours.cores] == [c.shape
                                                    for c in ref.cores]
    ref_t = _t(JU.stack_tt(ref))
    assert TU.uniform_rel_error(TU.stack_tt(ours), ref_t) <= REC_TOL
    err = TU.uniform_rel_error(TU.stack_tt(ours), X)
    assert abs(err - JU.uniform_rel_error(JU.stack_tt(ref), decay)) <= 1e-12
    assert err <= 1e-10   # the recovered tensor is exact up to roundoff


def test_sketch_argument_checks():
    tt = TU.unstack_tt(*TU.uniform_random_tt(5, 4, 3, seed=0))
    with pytest.raises(ValueError, match="right_rank > left_rank"):
        TU.uniform_orthogonal_sketch(tt, 4, 4, seed=1)
    with pytest.raises(ValueError, match="left_rank <= mode size"):
        TU.uniform_orthogonal_sketch(tt, 5, 8, seed=1)
    with pytest.raises(ValueError, match="max_rank"):
        TU.uniform_round_fixed(*TU.stack_tt(tt), max_rank=5)


def test_exact_recovery_and_seeds():
    tt = TU.unstack_tt(*TU.uniform_random_tt(6, 4, 3, seed=1))
    X = TU.stack_tt(tt)
    rec1, _ = TU.uniform_stream_sketch(tt, 3, 6, seed=11)
    rec2, _ = TU.uniform_stream_sketch(tt, 3, 6, seed=11)
    rec3, _ = TU.uniform_stream_sketch(tt, 3, 6, seed=12)
    assert all(torch.equal(a, b) for a, b in zip(rec1.cores, rec2.cores))
    assert not all(torch.allclose(a, b)
                   for a, b in zip(rec1.cores, rec3.cores))
    assert TU.uniform_rel_error(TU.stack_tt(rec1), X) < 1e-9
    hmt = TU.uniform_hmt_sketch(tt, 4, seed=13)
    assert TU.uniform_rel_error(TU.stack_tt(hmt), X) < 1e-9
    otts = TU.uniform_orthogonal_sketch(tt, 4, 8, seed=15)
    assert otts.cores[1].shape == (4, 4, 4)
    assert TU.uniform_rel_error(TU.stack_tt(otts), X) < 1e-9


# -- rounding, dot, norm, add, errors ---------------------------------------

@pytest.mark.parametrize("k", [3, 2, 1])
def test_round_fixed_against_jax(decay, k):
    X = _t(decay)
    ours = TU.uniform_round_fixed(*X, max_rank=k)
    ref = JU.uniform_round_fixed(*decay, max_rank=k)
    assert tuple(ours[1].shape) == ref[1].shape == (6, k, 6, k)
    assert TU.uniform_rel_error(ours, _t(ref)) <= REC_TOL
    e_ours = TU.uniform_rel_error(ours, X)
    e_ref = JU.uniform_rel_error(ref, decay)
    assert abs(e_ours - e_ref) <= ROW_TOL * e_ref + ROW_FLOOR


def test_one_orthogonalization_serves_several_ranks(decay):
    """``_truncate_fixed`` of one ``uniform_orthogonalize`` equals
    ``uniform_round_fixed`` at each rank bit for bit (the same operations
    on the same values)."""
    X = _t(decay)
    orth = TU.uniform_orthogonalize(*X)
    for k in (3, 2, 1):
        ours = TU._truncate_fixed(*orth, max_rank=k)
        ref = TU.uniform_round_fixed(*X, max_rank=k)
        assert all(torch.equal(a, b) for a, b in zip(ours, ref))


def test_round_fixed_rank_deficient_first_core():
    """n < r: the first QR is zero-padded back to rank r."""
    st = JU.uniform_random_tt(6, 3, 5, seed=4)
    ours = TU.uniform_round_fixed(*_t(st), max_rank=3)
    ref = JU.uniform_round_fixed(*st, max_rank=3)
    assert TU.uniform_rel_error(ours, _t(ref)) <= REC_TOL
    q = TU.uniform_orthogonalize(*_t(st))
    assert tuple(q[0].shape) == (1, 3, 5)
    assert _rel(TU.unstack_tt(*q).to_dense().numpy(),
                JU.unstack_tt(*st).to_dense()) <= REC_TOL


def test_dot_norm_add_rel_error_against_jax():
    A = JU.uniform_random_tt(5, 3, 3, seed=5)
    B = JU.uniform_random_tt(5, 3, 2, seed=6)
    a, b = _t(A), _t(B)
    dot = TU.uniform_dot(a, b)
    assert dot.dim() == 0
    assert float(dot) == pytest.approx(float(JU.uniform_dot(A, B)),
                                       rel=REC_TOL)
    assert float(TU.uniform_norm(*a)) == pytest.approx(
        float(JU.uniform_norm(*A)), rel=REC_TOL)
    total = TU.uniform_add(a, b)
    assert [tuple(x.shape) for x in total] == [x.shape
                                               for x in JU.uniform_add(A, B)]
    dense = (JU.unstack_tt(*A).to_dense() + JU.unstack_tt(*B).to_dense())
    assert _rel(TU.unstack_tt(*total).to_dense().numpy(), dense) <= 1e-12
    assert TU.uniform_rel_error(a, a) < 1e-12
    assert TU.uniform_rel_error(a, b) == pytest.approx(
        JU.uniform_rel_error(A, B), rel=REC_TOL)


def test_gram_route_against_exact():
    st = TU.uniform_exp_decay_tt(10, 6, 5, seed=2, min_svdval=-2.0)
    rounded = TU.uniform_round_fixed(*st, max_rank=3)
    exact = TU._rel_error_exact(rounded, st)
    gram = TU._rel_error_gram(rounded, st)
    assert exact == TU.uniform_rel_error(rounded, st)   # the CPU's route
    assert 1e-2 < exact < 1e-1
    assert abs(gram - exact) <= GRAM_TOL * exact


def test_large_order_smoke():
    """d = 256 (``tests/test_uniform.py``'s smoke test) on the JAX
    package's tensor, with both DRM streams."""
    X = _t(JU.uniform_random_tt(256, 4, 3, seed=11))
    for stream in ("torch", "hash"):
        ours, _ = TU.uniform_stream_sketch(TU.unstack_tt(*X), 3, 6, seed=14,
                                           drm_stream=stream)
        assert TU.uniform_rel_error(TU.stack_tt(ours), X) < 1e-7


# -- the order-scaling rows of run_dimension_scaling(quick=True) -------------

def _port_row(method, stacked, order, rank):
    """One row of ``run_dimension_scaling(quick=True)`` (dim 6, rank 5,
    rounding to ``rank``) computed with the port's functions as
    ``tt_sketch_tpu/experiments/tasks.py:140-222`` computes it."""
    tt = TU.unstack_tt(*stacked)
    if method == "TT-SVD":
        out = TU.uniform_round_fixed(*stacked, max_rank=rank)
    elif method == "STTA":
        rec, _ = TU.uniform_stream_sketch(
            tt, 5, 10, seed=_seed_for(order, 0, 4), drm_stream="hash")
        out = TU.uniform_round_fixed(*TU.stack_tt(rec), max_rank=rank)
    elif method == "HMT":
        rec = TU.uniform_hmt_sketch(tt, 5, seed=_seed_for(order, 0, 5),
                                    drm_stream="hash")
        out = TU.uniform_round_fixed(*TU.stack_tt(rec), max_rank=rank)
    else:
        rec = TU.uniform_orthogonal_sketch(
            tt, min(5, 6), 10, seed=_seed_for(order, 0, 7),
            drm_stream="hash")
        out = TU.uniform_round_fixed(*TU.stack_tt(rec), max_rank=rank)
    return TU.uniform_rel_error(out, stacked)


def _jax_row(method, stacked, order, rank):
    if method == "TT-SVD":
        row = jtasks.experiment_uniform_tt_round(stacked, rank=rank)
    elif method == "STTA":
        row = jtasks.experiment_uniform_stream_sketch(
            stacked, 5, 10, rank, seed=_seed_for(order, 0, 4),
            drm_stream="hash")
    elif method == "HMT":
        row = jtasks.experiment_uniform_hmt_sketch(
            stacked, 5, rank, seed=_seed_for(order, 0, 5), drm_stream="hash")
    else:
        row = jtasks.experiment_uniform_orthogonal_sketch(
            stacked, min(5, 6), 10, rank, seed=_seed_for(order, 0, 7),
            drm_stream="hash")
    return row["error"]


#: the quick run's rows (TT-SVD at 3, 2, 1; the sketches rounded to 3),
#: and the sketches rounded to 1, where the error is not at roundoff
SCALING_ROWS = ([("TT-SVD", k) for k in (3, 2, 1)]
                + [(m, k) for m in ("STTA", "HMT", "OTTS") for k in (3, 1)])


@pytest.mark.parametrize("order", [8, 16])
@pytest.mark.parametrize("method,rank", SCALING_ROWS)
def test_dimension_scaling_rows(order, method, rank):
    stacked = JU.uniform_exp_decay_tt(order, 6, 5, 179)
    ours = _port_row(method, _t(stacked), order, rank)
    ref = _jax_row(method, stacked, order, rank)
    assert abs(ours - ref) <= ROW_TOL * ref + ROW_FLOOR
