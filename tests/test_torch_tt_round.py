"""TT rounding, singular values and the utilities of the solver slice of
``tt_sketch_torch`` against ``tt_sketch_tpu`` on the CPU.

The inputs are TTs drawn from seeds (``TensorTrain.random`` gives
bit-identical cores in both packages) and sums of them with decaying
coefficients, whose singular values keep away from the eps thresholds
tested, so both packages pick the same ranks.  A QR and an SVD sit in every
rounding sweep and their column signs are the library's choice, so rounded
TTs are compared as dense tensors, never core by core.  Tolerances, with
their reasons:

- ranks, host RNG draws, synthetic tensors, COO indices: exact;
- rounded dense tensors and singular values: 1e-12 relative to the largest
  value (the same float64 SVDs in another library);
- masked against host-read rounding in the port: 1e-12 absolute, as
  ``tests/test_solvers.py::test_tt_round_masked_matches_host``; a masked TT
  against its slice to the effective ranks: 1e-14 relative (the dropped
  products are exact zeros, but torch's ``einsum`` sums in another order
  at other ranks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_sketch_torch import config
from tt_sketch_torch import utils as tu
from tt_sketch_torch.formats import DenseTensor, TensorTrain, tt_ops
from tt_sketch_tpu import utils as ju
from tt_sketch_tpu.formats import DenseTensor as JDense
from tt_sketch_tpu.formats import TensorTrain as JTrain
from tt_sketch_tpu.formats import tt_ops as jops

SHAPE = (6, 7, 8, 5)
#: (eps, max_rank) pairs: every eps sits at least 1.2x from a singular-value
#: ratio of ``_sum_pair()``'s unfoldings (0.412, 0.248, 0.058, 0.036, ...)
ROUND_CASES = [(0.3, None), (0.1, None), (1e-2, 4), (1e-2, None),
               (1e-4, 5), (1e-4, None), (None, 4), (0.1, (5, 2, 3))]


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _sum_pair(shape=SHAPE, terms=3, rank=3, scale=0.05):
    """The same direct sum of ``terms`` random TTs in both packages."""
    ours = [TensorTrain.random(shape, rank, seed=i) * (scale ** i)
            for i in range(terms)]
    ref = [JTrain.random(shape, rank, seed=i) * (scale ** i)
           for i in range(terms)]
    tt, jt = ours[0], ref[0]
    for a, b in zip(ours[1:], ref[1:]):
        tt, jt = tt.add(a), jt.add(b)
    return tt, jt


def _dense_close(ours, ref, rel=1e-12, atol=None):
    b = np.asarray(ref)
    a = ours.cpu().numpy() if isinstance(ours, torch.Tensor) else ours
    tol = rel * np.abs(b).max() if atol is None else atol
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("eps, max_rank", ROUND_CASES)
def test_tt_round_matches_jax(eps, max_rank):
    tt, jt = _sum_pair()
    ours = TensorTrain(tt_ops.tt_round(tt.cores, eps, max_rank))
    ref = JTrain(jops.tt_round(jt.cores, eps, max_rank))
    assert ours.rank == ref.rank
    _dense_close(ours.to_dense(), ref.to_dense())


@pytest.mark.parametrize("eps, max_rank", ROUND_CASES)
def test_tt_round_masked_matches_host_and_jax(eps, max_rank):
    """Masked static-rank rounding represents the tensor of the host-read
    rounding and reports its ranks (the check of
    ``tests/test_solvers.py::test_tt_round_masked_matches_host``), in the
    port and against the JAX package's masked rounding."""
    tt, jt = _sum_pair()
    host = tt.round(eps=eps, max_rank=max_rank)
    masked, eff = tt.round_masked(eps=eps, max_rank=max_rank)
    j_masked, j_eff = jt.round_masked(eps=eps, max_rank=max_rank)
    assert eff.dtype == torch.int32 and eff.shape == (len(SHAPE) - 1,)
    assert eff.tolist() == np.asarray(j_eff).tolist()
    assert masked.rank == JTrain(j_masked.cores).rank
    if eps is not None:
        assert tuple(eff.tolist()) == host.rank
    _dense_close(masked.to_dense(), host.to_dense().numpy(), atol=1e-12)
    _dense_close(masked.to_dense(), j_masked.to_dense())
    trimmed = masked.trim_to_ranks(eff)
    assert trimmed.rank == tuple(eff.tolist())
    # the sliced-off products are exact zeros; only the einsum's blocking
    # (and so its summation order) changes with the ranks
    _dense_close(trimmed.to_dense(), masked.to_dense().numpy(), rel=1e-14)


def test_masked_rounding_zeroes_rows_past_the_eps_rank():
    """Core μ's rows past the eps rank of its left edge are exact zeros;
    the matching columns of core μ-1 multiply only those rows."""
    tt, _ = _sum_pair()
    masked, eff = tt.round_masked(eps=0.1, max_rank=6)
    assert masked.rank == (6, 6, 5)
    assert min(eff.tolist()) >= 1 and max(eff.tolist()) < 5
    for mu, r in enumerate(eff.tolist()):
        assert masked.cores[mu + 1][r:].abs().max() == 0


def test_masked_eps_may_be_a_tensor():
    tt, _ = _sum_pair()
    a, eff_a = tt.round_masked(eps=1e-2, max_rank=5)
    b, eff_b = tt.round_masked(eps=torch.tensor(1e-2, dtype=torch.float64),
                               max_rank=5)
    assert eff_a.tolist() == eff_b.tolist()
    np.testing.assert_array_equal(a.to_dense().numpy(), b.to_dense().numpy())


@pytest.mark.parametrize("max_rank", [1, 3, 5, (2, 9, 4), 40])
def test_tt_round_fixed_rank_matches_jax(max_rank):
    tt, jt = _sum_pair()
    ours = TensorTrain(tt_ops.tt_round_fixed_rank(tt.cores, max_rank))
    ref = JTrain(jops.tt_round_fixed_rank(jt.cores, max_rank))
    assert ours.rank == ref.rank
    _dense_close(ours.to_dense(), ref.to_dense())


def test_rank_rules_of_the_three_sweeps():
    """A rank-2 TT padded with zeros to rank 3: the fixed-rank sweep keeps
    ``min(rows, cols, max_rank)`` = 3 values, the zero one included (no
    eps); ``tt_round`` keeps the 2 above ``S[0]·eps`` and clamps an empty
    eps rank to 1; the masked sweep keeps static rank 3 and reports the
    same eps ranks.  The JAX package gives the same ranks."""
    base = TensorTrain.random((3, 4, 5), 2, seed=0).cores
    cores = [torch.nn.functional.pad(c, (0, 1 if i < 2 else 0, 0, 0,
                                         0, 1 if i > 0 else 0))
             for i, c in enumerate(base)]
    j_cores = [jnp.asarray(c.numpy()) for c in cores]
    assert tuple(c.shape[0] for c in cores[1:]) == (3, 3)
    cases = {
        "fixed": (lambda c: tt_ops.tt_round_fixed_rank(c, 4),
                  lambda c: jops.tt_round_fixed_rank(c, 4), (3, 3)),
        "eps": (lambda c: tt_ops.tt_round(c, 1e-8, 4),
                lambda c: jops.tt_round(c, 1e-8, 4), (2, 2)),
        "clamp": (lambda c: tt_ops.tt_round(c, 10.0, 4),
                  lambda c: jops.tt_round(c, 10.0, 4), (1, 1)),
        "masked": (lambda c: tt_ops.tt_round_masked(c, 1e-8, 4)[0],
                   lambda c: jops.tt_round_masked(c, 1e-8, 4)[0], (3, 3)),
    }
    for name, (ours, ref, ranks) in cases.items():
        assert tuple(c.shape[0] for c in ours(cores)[1:]) == ranks, name
        assert tuple(int(c.shape[0]) for c in ref(j_cores)[1:]) == ranks
    assert tt_ops.tt_round_masked(cores, 1e-8, 4)[1].tolist() == [2, 2]
    assert tt_ops.tt_round_masked(cores, 10.0, 4)[1].tolist() == [1, 1]


def test_orthogonalized_input_skips_the_sweep():
    tt, jt = _sum_pair()
    orth = tt.orthogonalize()
    for fn in (lambda c, o: tt_ops.tt_round(c, 1e-2, 5, orthogonalized=o),
               lambda c, o: tt_ops.tt_round_fixed_rank(c, 5, orthogonalized=o),
               lambda c, o: tt_ops.tt_round_masked(c, 1e-2, 5,
                                                   orthogonalized=o)[0]):
        a = TensorTrain(fn(orth.cores, True)).to_dense()
        b = TensorTrain(fn(tt.cores, False)).to_dense()
        _dense_close(a, b.numpy())


@pytest.mark.parametrize("ranks", [(1, 1, 1), (2, 3, 1), (6, 9, 5)])
def test_tt_slice_to_ranks_matches_jax(ranks):
    tt, jt = _sum_pair()
    for given in (ranks, np.asarray(ranks), torch.tensor(ranks)):
        ours = tt_ops.tt_slice_to_ranks(tt.cores, given)
        ref = jops.tt_slice_to_ranks(jt.cores, np.asarray(ranks))
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("shape, rank", [(SHAPE, None), ((3, 4, 5), 2),
                                         ((10, 2, 7, 3, 4), 3)])
def test_svdvals_match_jax(shape, rank):
    if rank is None:
        tt, jt = _sum_pair()
    else:
        tt, jt = TensorTrain.random(shape, rank, seed=4), JTrain.random(
            shape, rank, seed=4)
    ours, ref = tt.svdvals(), jt.svdvals()
    direct = tt_ops.tt_svdvals(tt.cores)
    assert len(ours) == len(ref) == len(shape)
    norm = tt.norm()
    for a, b, c in zip(ours, ref, direct):
        assert isinstance(a, np.ndarray) and a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * b[0])
        np.testing.assert_array_equal(a, c)
        # every unfolding carries the whole norm
        assert abs(np.linalg.norm(a) - norm) <= 1e-12 * norm


def test_norm_and_dot_on_the_device():
    tt, jt = _sum_pair()
    other = TensorTrain.random(SHAPE, 4, seed=9)
    j_other = JTrain.random(SHAPE, 4, seed=9)
    n = tt.norm_device()
    d = tt.dot_device(other)
    for x in (n, d):
        assert isinstance(x, torch.Tensor) and x.ndim == 0
        assert x.device == tt.device
    assert float(n) == tt.norm()
    assert float(tt_ops.tt_norm_device(tt.cores)) == tt.norm()
    np.testing.assert_allclose(float(n), float(jt.norm_device()), rtol=1e-13)
    np.testing.assert_allclose(float(d), float(jt.dot_device(j_other)),
                               rtol=1e-12)
    assert float(d) == tt.dot(other)


def test_round_routes_as_the_jax_package(monkeypatch):
    """``eps=None`` with a ``max_rank`` takes the fixed-rank sweep, every
    other call the host-read sweep (``tensor_train.py:65-83``)."""
    calls = []
    for name in ("tt_round", "tt_round_fixed_rank"):
        fn = getattr(tt_ops, name)
        monkeypatch.setattr(
            tt_ops, name,
            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    tt, jt = _sum_pair()
    for eps, max_rank, route in ((None, 4, "tt_round_fixed_rank"),
                                 (1e-2, 4, "tt_round"),
                                 (1e-2, None, "tt_round"),
                                 (None, None, "tt_round")):
        calls.clear()
        ours = tt.round(eps=eps, max_rank=max_rank)
        assert calls == [route]
        ref = jt.round(eps=eps, max_rank=max_rank)
        assert ours.rank == ref.rank
        _dense_close(ours.to_dense(), ref.to_dense())


@pytest.mark.parametrize("shape", [(3, 4, 2), (5,), (2, 3, 1, 4)])
def test_to_sparse_matches_jax(shape):
    data = np.random.default_rng(0).standard_normal(shape)
    ours = DenseTensor(torch.from_numpy(data)).to_sparse()
    ref = JDense(jnp.asarray(data)).to_sparse()
    assert ours.shape == ref.shape
    assert ours.indices.dtype == torch.int64
    assert ours.indices.device == ours.entries.device == torch.device("cpu")
    np.testing.assert_array_equal(ours.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(ours.entries.numpy(),
                                  np.asarray(ref.entries))
    np.testing.assert_array_equal(ours.to_dense().numpy(), data)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_synthetic_tensors_bit_identical(dtype):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    pairs = [
        (tu.hilbert_tensor(4, 5, dtype=dtype),
         ju.hilbert_tensor(4, 5, dtype=jdtype)),
        (tu.sqrt_tensor((6, 7, 3), dtype=dtype),
         ju.sqrt_tensor((6, 7, 3), dtype=jdtype)),
        (tu.sqrt_tensor((4, 5), a=0.5, b=3.0, dtype=dtype),
         ju.sqrt_tensor((4, 5), a=0.5, b=3.0, dtype=jdtype)),
        (tu.power_decay_tensor((5, 6, 4), pow=3.0, seed=7, dtype=dtype),
         ju.power_decay_tensor((5, 6, 4), pow=3.0, seed=7, dtype=jdtype)),
    ]
    for ours, ref in pairs:
        assert ours.dtype == dtype and ours.device == torch.device("cpu")
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_synthetic_tensors_default_to_float64():
    for X in (tu.hilbert_tensor(2, 3), tu.sqrt_tensor((2, 3)),
              tu.power_decay_tensor((2, 3), seed=0)):
        assert X.dtype == torch.float64


@pytest.mark.parametrize("pow_", [1.0, 2.0, 4.0])
def test_power_decay_tensor_has_power_law_spectra(pow_):
    """The reference's version fails on a missing import (SURVEY §2.4); the
    port's runs.  Each mode's step multiplies its unfolding's normalized
    spectrum by ``k^-pow``: every unfolding decays at least as fast
    (``S_k / S_1 <= k^-pow``), and the unfolding treated last exactly so
    (``S_k k^pow / S_1`` is the non-increasing spectrum it had)."""
    shape = (6, 5, 7)
    X = tu.power_decay_tensor(shape, pow=pow_, seed=0)
    for mode in range(len(shape)):
        S = np.linalg.svd(tu.matricize(X, mode).numpy(), compute_uv=False)
        scaled = S / S[0] * np.arange(1, len(S) + 1) ** pow_
        assert np.all(scaled[1:] < 1.0)
        if mode == len(shape) - 1:
            assert np.all(np.diff(scaled) <= 1e-12)


@pytest.mark.parametrize("threads, shape, seed",
                         [(1, (7, 5), 0), (4, (7, 5), 3), (3, (10,), 11),
                          (16, (2, 3), 5)])
def test_reference_random_normal_bit_identical(threads, shape, seed):
    ours = tu.reference_random_normal(shape, seed, threads)
    assert isinstance(ours, np.ndarray)
    np.testing.assert_array_equal(
        ours, ju.reference_random_normal(shape, seed, threads))


@pytest.mark.parametrize("cols", [(3, None), (3, 3), (2, 4)])
def test_projector_matches_jax(cols):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((9, cols[0]))
    Y = None if cols[1] is None else rng.standard_normal((9, cols[1]))
    ours = tu.projector(torch.from_numpy(X),
                        None if Y is None else torch.from_numpy(Y))
    ref = ju.projector(jnp.asarray(X), None if Y is None else jnp.asarray(Y))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    if cols[1] == cols[0] or cols[1] is None:
        # an oblique projector is idempotent and fixes the range of X
        P = ours.numpy()
        np.testing.assert_allclose(P @ P, P, atol=1e-12)
        np.testing.assert_allclose(P @ X, X, atol=1e-12)
