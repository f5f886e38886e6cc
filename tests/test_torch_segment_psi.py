"""The Ψ segment reduction of the port (``kernels/segment_psi.py``) against
the JAX package's ``_psi_sparse_segment``, which takes
``jax.ops.segment_sum`` off a TPU.

Tolerances: float64 ``1e-10`` absolute (the same products summed in
another order); float32 ``2e-5·max|ref|`` (float32 sums of a few thousand
terms in another order).  On the CPU the wrapper takes its plain version;
the kernel runs only on a CUDA card, where the last test holds it against
the plain version.

Indices come at random or in runs, as a COO file sorted by its leading
modes gives them (FROSTT-uber: mode 0 sorted, mode 1 in runs of 2652).
The kernel sums a run in registers and adds it to its row once; a numpy
emulation of that order (runs cut at the blocks' ranges, dropped indices,
partials summed over the blocks as the second kernel sums them), at the
ranges ``segment_chunks`` gives the kernel, is held to the JAX result.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_sketch_torch import config, profiling
from tt_sketch_torch.kernels import segment_psi as SG
from tt_sketch_torch.kernels import sketch_kernels as K
from tt_sketch_tpu.kernels import sketch_kernels as JK

SIDES = [(4, 8), (None, 8), (4, None), (None, None)]


def _launches(wrapper):
    """The launches counted for kernel wrapper ``wrapper`` so far."""
    return profiling.counters().get(f"launches.{wrapper}", 0)


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _operands(n_mu, r1, r2, nnz=3001, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    left = None if r1 is None else rng.standard_normal((r1, nnz)).astype(dtype)
    right = None if r2 is None else rng.standard_normal((r2, nnz)).astype(dtype)
    ent = rng.standard_normal(nnz).astype(dtype)
    idx = rng.integers(0, n_mu, nnz)
    return left, right, ent, idx


#: index patterns: random, and the runs the kernel is designed for
RUNS = ("sorted", "runs over 24 rows", "runs across blocks", "one run",
        "a new row every nonzero", "dropped inside a run")


def _run_indices(kind, n_mu, nnz, rng):
    """int64 mode indices of ``nnz`` nonzeros in the pattern ``kind``."""
    if kind == "sorted":  # uber's mode 0: 52 of 183 rows, equal runs
        rows = np.sort(rng.choice(n_mu, min(52, n_mu), replace=False))
        return np.repeat(rows, -(-nnz // rows.size))[:nnz]
    if kind == "one run":
        return np.full(nnz, n_mu // 2)
    if kind == "a new row every nonzero":
        return np.arange(nnz) % n_mu
    if kind == "runs across blocks":  # each run one nonzero longer than a
        chunk, _ = SG.segment_chunks(nnz, n_mu, 1)  # block's range
        lengths = np.full(nnz // chunk + 2, chunk + 1)
        lengths[0] = chunk // 2
    else:  # runs over 24 rows (uber's mode 1), or with dropped indices
        lengths = rng.integers(400, 1000, nnz // 400 + 1)
    rows = rng.integers(0, n_mu, lengths.size)
    idx = np.repeat(rows, lengths)[:nnz]
    if kind == "dropped inside a run":
        idx[nnz // 3], idx[nnz // 2] = n_mu, -1
    return idx


def _jax_psi(ops, n_mu):
    """The JAX package's Ψ of numpy operands, as (n_mu, r1, r2)."""
    ref = JK._psi_sparse_segment(
        *(None if a is None else jnp.asarray(a) for a in ops), n_mu)
    return np.asarray(ref).transpose(1, 0, 2)


def _torch(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("r1, r2", SIDES)
@pytest.mark.parametrize("n_mu", [24, 183])
def test_cpu_takes_the_plain_version_and_matches_segment_sum(n_mu, r1, r2,
                                                             dtype):
    ops = _operands(n_mu, r1, r2, dtype=dtype, seed=n_mu)
    before = _launches("psi_segment")
    got = SG.psi_segment(*_torch(*ops), n_mu)
    assert _launches("psi_segment") == before
    assert torch.equal(got, SG.psi_segment_reference(*_torch(*ops), n_mu))
    ref = np.asarray(JK._psi_sparse_segment(
        *(None if a is None else jnp.asarray(a) for a in ops), n_mu))
    assert not JK._use_onehot_segments(n_mu)
    ref = ref.transpose(1, 0, 2)  # (n_mu, r1, r2)
    assert got.dtype == torch.from_numpy(ops[2]).dtype
    assert tuple(got.shape) == ref.shape == (n_mu, r1 or 1, r2 or 1)
    atol = 1e-10 if dtype == np.float64 else 2e-5 * np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)


def test_operands_promote_as_the_plain_version():
    left, right, ent, idx = _operands(24, 3, 5, dtype=np.float32)
    lb = torch.from_numpy(left).to(torch.bfloat16)
    got = SG.psi_segment(lb, torch.from_numpy(right), torch.from_numpy(ent),
                         torch.from_numpy(idx), 24)
    assert got.dtype == torch.float32
    assert torch.equal(got, SG.psi_segment_reference(
        lb, torch.from_numpy(right), torch.from_numpy(ent),
        torch.from_numpy(idx), 24))


@pytest.mark.parametrize("n_mu, r1, r2, kernel", [
    (1470, 10, 20, True), (1471, 10, 20, False),
    (12160, None, 3, True), (12161, None, 3, False)])
def test_large_psi_scatters_on_every_device(monkeypatch, n_mu, r1, r2,
                                            kernel):
    # the sketch sends a Ψ that segment_fits to the wrapper (the kernel on
    # CUDA) and scatters a larger one with the plain version, counted as a
    # fallback.  In float64, 2 x 4 micro-tiles (ranks 10 x 20) hold 1470
    # rows beside a ring of MIN_TK nonzeros, 1 x 1 (no left side, rank 3)
    # 12160: 64 or 8 bytes of bins a row, the ring 9216 or 1184 bytes
    routed = []
    monkeypatch.setattr(K, "psi_segment",
                        lambda *a: routed.append(a[4]) or SG.psi_segment(*a))
    ops = _torch(*_operands(n_mu, r1, r2, nnz=500))
    assert SG.segment_fits(ops[0], ops[1], n_mu, torch.float64) == kernel
    profiling.reset_counters()
    psi = K._psi_sparse_segment(*ops, n_mu)
    assert routed == ([n_mu] if kernel else [])
    assert profiling.counters().get("fallbacks.psi_index_add", 0) == (
        0 if kernel else 1)
    assert torch.equal(psi, SG.psi_segment_reference(*ops, n_mu)
                       .permute(1, 0, 2))
    if not kernel:
        with pytest.raises(ValueError, match="beyond the kernel's fit"):
            SG.psi_segment(*ops, n_mu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ubers_mode_1_psi_takes_the_kernel(monkeypatch, dtype):
    # uber's mode 1 at the benchmark's ranks 20/40: 24 rows x 20 x 40 =
    # 19,200 values, 2 x 4 micro-tiles of 32 (float32) or 64 (float64)
    # bytes of bins a row, far inside the fit
    n_mu, nnz = 24, 6_001
    left, right, ent, idx = _torch(*_operands(n_mu, 20, 40, nnz=nnz,
                                              dtype=np.float64))
    left, right, ent = (t.to(dtype) for t in (left, right, ent))
    assert SG.segment_fits(left, right, n_mu, dtype)
    assert SG.psi_dtype(left, right, ent) == dtype
    routed = []
    monkeypatch.setattr(K, "psi_segment",
                        lambda *a: routed.append(a[4]) or SG.psi_segment(*a))
    profiling.reset_counters()
    psi = K._psi_sparse_segment(left, right, ent, idx, n_mu)
    assert routed == [n_mu]
    assert "fallbacks.psi_index_add" not in profiling.counters()
    assert tuple(psi.shape) == (20, n_mu, 40) and psi.dtype == dtype
    assert torch.equal(psi, SG.psi_segment_reference(left, right, ent, idx,
                                                     n_mu).permute(1, 0, 2))


def test_fit_rule_reads_the_kernels_constants():
    # segment_fits mirrors the C entry's rule: its constants and its
    # count of instructions a quad are the kernel source's
    src = (Path(SG.__file__).parents[1] / "csrc"
           / "segment_psi.cu").read_text()
    consts = dict(re.findall(r"constexpr (?:int|size_t) (\w+) = ([^;]+);",
                             src))
    assert eval(consts["SMEM_BUDGET"]) == SG.SMEM_BUDGET
    assert int(consts["MIN_TK"]) == SG.MIN_TK
    assert int(consts["NSTAGE"]) == SG.NSTAGE
    assert f"(int64_t)r1 * r2 <= {SG.MAX_PAIRS}" in src
    assert "warps * (6 + ta + tb + 4 * ta + 4 * ta * tb)" in src
    # wide tiles where they issue fewer instructions: 20 x 40 and 10 x 20
    # (uber's modes 1), 1 x 1 for a rank-1 side (uber's mode 0)
    assert SG._wide_tiles(20, 40) and SG._wide_tiles(10, 20)
    assert not SG._wide_tiles(1, 40) and not SG._wide_tiles(4, 8)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("r1, r2", [(4, 8), (None, 8)])
@pytest.mark.parametrize("kind", RUNS)
def test_indices_in_runs_match_segment_sum(kind, r1, r2, dtype):
    n_mu, nnz = (183, 70_001) if kind == "sorted" else (24, 6_001)
    rng = np.random.default_rng(len(kind))
    left, right, ent, _ = _operands(n_mu, r1, r2, nnz=nnz, dtype=dtype,
                                    seed=len(kind))
    ops = (left, right, ent, _run_indices(kind, n_mu, nnz, rng))
    got = SG.psi_segment(*_torch(*ops), n_mu)
    ref = _jax_psi(ops, n_mu)
    assert tuple(got.shape) == ref.shape == (n_mu, r1 or 1, r2 or 1)
    atol = 1e-10 if dtype == np.float64 else 2e-5 * np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)


def emulate_kernel(left, right, ent, idx, n_mu, chunk, n_chunks):
    """The kernel's summation in numpy: block c sums each run of one row in
    its range ``[c·chunk, (c+1)·chunk)`` (the run cut at the range's ends)
    and adds the run to that row's bins when the row changes; runs of
    indices outside ``[0, n_mu)`` add nothing; warp w of the second kernel
    sums the blocks w, w + REDUCE_WARPS, ... (the kernel's constant), and
    the warps' sums are added in order."""
    w = ent[None, :] * (1 if left is None else left)
    r = np.ones((1, ent.size)) if right is None else right
    rows = np.where((idx >= 0) & (idx < n_mu), idx, -1)
    parts = np.zeros((n_chunks, n_mu, w.shape[0], r.shape[0]))
    for c in range(n_chunks):
        k0, k1 = c * chunk, min(ent.size, (c + 1) * chunk)
        cut = np.flatnonzero(np.diff(rows[k0:k1])) + 1 + k0
        for s, e in zip(np.r_[k0, cut], np.r_[cut, k1]):
            if rows[s] >= 0:
                parts[c, rows[s]] += w[:, s:e] @ r[:, s:e].T
    src = (Path(SG.__file__).parents[1] / "csrc"
           / "segment_psi.cu").read_text()
    warps = int(re.search(r"constexpr int REDUCE_WARPS = (\d+);", src)[1])
    sums = [parts[q::warps].sum(axis=0) for q in range(min(warps, n_chunks))]
    return functools.reduce(np.add, sums)


@pytest.mark.parametrize("kind", ("random",) + RUNS)
def test_kernel_order_at_its_ranges_matches_segment_sum(kind):
    n_mu, nnz = (183, 70_001) if kind == "sorted" else (24, 6_001)
    rng = np.random.default_rng(7)
    left, right, ent, idx = _operands(n_mu, 3, 5, nnz=nnz, seed=7)
    if kind != "random":
        idx = _run_indices(kind, n_mu, nnz, rng)
    chunk, n_chunks = SG.segment_chunks(nnz, n_mu, 15)
    assert n_chunks > 1
    got = emulate_kernel(left, right, ent, idx, n_mu, chunk, n_chunks)
    np.testing.assert_allclose(got, _jax_psi((left, right, ent, idx), n_mu),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("nnz, n_mu, pairs", [
    (0, 24, 200), (1, 1, 1), (1023, 183, 20), (5000, 24, 200),
    (3_309_490, 183, 20), (3_309_490, 24, 200), (3_309_490, 4096, 200)])
def test_segment_chunks_cover_the_nonzeros(nnz, n_mu, pairs):
    chunk, n_chunks = SG.segment_chunks(nnz, n_mu, pairs)
    assert chunk >= 1 and 1 <= n_chunks <= SG._TARGET_BLOCKS
    assert chunk * n_chunks >= nnz
    assert nnz == 0 or (n_chunks - 1) * chunk < nnz  # no block is empty
    assert n_chunks == 1 or n_chunks * n_mu * pairs <= SG._MAX_PARTIALS
    assert chunk >= min(SG._MIN_CHUNK, nnz)
    assert chunk % 4 == 0  # every block's range starts 16-byte aligned


def test_raises_off_cpu_without_kernel():
    # a tensor that is neither on the CPU nor on CUDA never reaches the
    # plain version: the wrapper launches or raises
    meta = {"device": "meta"}
    left, right = torch.empty((4, 64), **meta), torch.empty((8, 64), **meta)
    ent = torch.empty(64, **meta)
    idx = torch.empty(64, dtype=torch.int64, **meta)
    before = _launches("psi_segment")
    with pytest.raises(ValueError, match="CUDA device"):
        SG.psi_segment(left, right, ent, idx, 24)
    # one operand on the CPU and one elsewhere is not the plain path
    with pytest.raises(ValueError, match="CUDA device"):
        SG.psi_segment(None, None, ent, torch.zeros(64, dtype=torch.int64),
                       24)
    assert _launches("psi_segment") == before


@pytest.mark.parametrize("kind", ("random", "sorted", "runs over 24 rows",
                                  "dropped inside a run"))
@pytest.mark.parametrize("r1, r2", SIDES)
@pytest.mark.parametrize("n_mu, nnz, dtype", [
    (24, 100_003, np.float32), (183, 5000, np.float32),
    (512, 20_000, np.float32), (512, 20_000, np.float64)])
def test_kernel_matches_plain_version_on_the_card(n_mu, nnz, dtype, r1, r2,
                                                  kind):
    # 512 rows x 4 x 8 pairs: 16384 values; in float64 bins that squeeze
    # the ring, so the plan within 113 KB (two tiles of bins)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    ops = _operands(n_mu, r1, r2, nnz=nnz, dtype=dtype)
    if kind != "random":
        ops = ops[:3] + (_run_indices(kind, n_mu, nnz,
                                      np.random.default_rng(1)),)
    ops = tuple(None if a is None else torch.from_numpy(a).cuda()
                for a in ops)
    before = _launches("psi_segment")
    got = SG.psi_segment(*ops, n_mu)
    ref = SG.psi_segment_reference(*ops, n_mu)
    assert _launches("psi_segment") == before + 1
    assert torch.equal(got, SG.psi_segment(*ops, n_mu))  # a fixed order
    tol = 1e-12 if dtype == np.float64 else 2e-5
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) <= tol
