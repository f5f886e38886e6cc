"""What the chain step kernel of ``tt_sketch_torch/csrc/chain_step.cu``
relies on, pinned on the CPU (the kernel itself runs only on the card).

1. ``chain_schedule``, the wrapper's one function of launch decisions: the
   padded row stride, the rank buckets, where the core lives (each block's
   shared memory or the cache), at every shape the sequential main paths
   record (FROSTT-uber HMT/OTTS and its TT-DRM's chain, FROSTT-lbnl HMT, all
   at rank 10) and at the edges: a core at the block budget and one row
   above, each bucket's edge, one rank past the largest bucket.
2. The kernel's layout of the core in rows of quads (``pack_rows``) and
   its bucketed register sums, emulated in float32 torch index for index
   (the bucket's loops and guards, 16-byte quads, sums over ``i`` in
   increasing order with a float32 FMA), against the
   plain version ``chain_step_t_reference`` and the JAX package's Pallas
   kernel in interpret mode within ``CHAIN_ULPS`` ulps of the largest
   output, as ``chip_smoke.py`` holds the kernel on the card; the first
   step bit for bit.
3. The constants the wrapper shares with the kernel source.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_sketch_torch import config
from tt_sketch_torch.kernels import chain_step as CS
from tt_sketch_tpu.kernels import pallas_chain as JC

SRC = (Path(__file__).resolve().parents[1] / "tt_sketch_torch" / "csrc"
       / "chain_step.cu").read_text()
#: chip_smoke.py's tolerance: max abs err in ulps (2^-23) of the largest
#: output (float32 sums of the same products in another order)
CHAIN_ULPS = 8
#: floats of a row at ranks 10/10 (5 x 5 quads: an odd count, no pad)
ROW10 = 100
ROWS_AT_BUDGET = CS.BLOCK_BUDGET // (4 * ROW10)


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


# -- 1. the launch decisions --------------------------------------------------

#: (n, r1, r2, first) -> (place, stride, buckets)
RECORDED = {
    # uber (183, 24, 1140, 1717): the HMT/OTTS left chain over modes 0-2
    (183, 1, 10, True): ("block", 12, (1, 12)),
    (24, 10, 10, False): ("block", 100, (16, 12)),
    (1140, 10, 10, False): ("cache", 100, (16, 12)),
    # the right TT-DRM's chain runs over modes 3-1
    (1717, 1, 10, True): ("block", 12, (1, 12)),
    # lbnl (1605, 4198, 1631, 4209, 868131): the left chain over modes 0-3
    (1605, 1, 10, True): ("block", 12, (1, 12)),
    (4198, 10, 10, False): ("cache", 100, (16, 12)),
    (1631, 10, 10, False): ("cache", 100, (16, 12)),
    (4209, 10, 10, False): ("cache", 100, (16, 12)),
}


@pytest.mark.parametrize("shape", list(RECORDED), ids=str)
def test_schedule_at_recorded_shapes(shape):
    place, stride, buckets = RECORDED[shape]
    s = CS.chain_schedule(*shape)
    assert (s.place, s.stride, (s.r1_bucket, s.r2_bucket)) == (
        place, stride, buckets)
    assert s.smem_bytes == (4 * shape[0] * stride if place == "block"
                            else 0) <= CS.BLOCK_BUDGET
    assert s.state_cols == 0


@pytest.mark.parametrize("n,row,first,place", [
    (ROWS_AT_BUDGET, ROW10, False, "block"),
    (ROWS_AT_BUDGET + 1, ROW10, False, "cache"),
    (CS.BLOCK_BUDGET // 48, 12, True, "block"),
    (CS.BLOCK_BUDGET // 48 + 1, 12, True, "cache"),
    (5000, ROW10, False, "cache"),
], ids=["at block budget", "one row above", "first step at the budget",
        "first step one row above", "a large core"])
def test_schedule_at_the_budget_edges(n, row, first, place):
    """A core lives in each block's shared memory up to the budget and is
    read through the cache one row above it."""
    s = CS.chain_schedule(n, 1 if first else 10, 10, first)
    assert (s.place, s.stride) == (place, row)
    assert s.smem_bytes == (4 * n * row if place == "block" else 0)
    assert (4 * n * row <= CS.BLOCK_BUDGET) == (place == "block")


@pytest.mark.parametrize("r,bucket", [
    (1, 4), (4, 4), (5, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32),
    (33, 0)])
def test_state_rank_buckets(r, bucket):
    s = CS.chain_schedule(30, r, 3, False)
    assert s.r1_bucket == bucket
    assert (s.r2_bucket == 0) == (bucket == 0)
    if bucket:
        assert 2 * math.ceil(r / 2) <= bucket


@pytest.mark.parametrize("r,bucket", [
    (1, 4), (4, 4), (5, 8), (8, 8), (9, 12), (12, 12), (13, 16), (16, 16),
    (17, 32), (32, 32), (33, 0)])
@pytest.mark.parametrize("first", [False, True], ids=["step", "first"])
def test_output_rank_buckets(r, bucket, first):
    s = CS.chain_schedule(30, 1 if first else 3, r, first)
    # the first step's row is r padded to 4, a step's r padded to 2: both
    # fall in the same bucket
    assert s.r2_bucket == bucket
    assert s.row == (4 * math.ceil(r / 4) if first  # r1 = 3: 4 padded
                     else 4 * 2 * math.ceil(r / 2))
    if bucket == 0:
        # the generic step stages the state of 256 nonzeros (r1 = 3)
        assert (s.r1_bucket, s.place, s.smem_bytes) == (
            0, "cache", 0 if first else 4 * 3 * 256)


@pytest.mark.parametrize("r1,r2,first", [
    (1, 10, True), (10, 10, False), (10, 20, False), (20, 20, False),
    (1, 1, False), (3, 5, False), (1, 7, True), (33, 3, False),
    (7, 40, False), (1, 40, True)])
def test_row_stride_is_odd_in_quads(r1, r2, first):
    """16-byte aligned rows whose starts cover all eight bank quads."""
    s = CS.chain_schedule(50, r1, r2, first)
    assert s.stride % 4 == 0 and (s.stride // 4) % 2 == 1
    assert s.row <= s.stride <= s.row + 4 and s.row % 4 == 0


@pytest.mark.parametrize("r1,cols", [(33, 256), (64, 256), (100, 160),
                                     (1000, 16), (5000, 3)])
def test_generic_state_stage(r1, cols):
    """Past the largest bucket a block stages the state of ``cols``
    nonzeros: the threads of a block while they fit the stage, else fewer
    (whole warps while there are 32)."""
    s = CS.chain_schedule(30, r1, 3, False)
    assert (s.r1_bucket, s.r2_bucket, s.place) == (0, 0, "cache")
    assert s.state_cols == cols and s.smem_bytes == 4 * r1 * cols
    assert s.smem_bytes <= max(CS.GENERIC_STATE_BYTES, 4 * r1)


# -- 2. the layout and the register sums, emulated ----------------------------

def _fma(a, b, c):
    """float32 fused multiply-add (the product of two float32 is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def pack_rows(core, sched):
    """``pack_rows`` of the kernel source, index for index: every float
    ``f`` of the ``(n, stride)`` rows from its row and column."""
    r1, n, r2 = core.shape
    f = torch.arange(n * sched.stride)
    row, c = f // sched.stride, f % sched.stride
    flat = core.float().reshape(-1)
    if sched.first:
        ok, src = c < r2, row * r2 + c
    else:
        nk2 = (r2 + 1) // 2
        quad = c >> 2
        i2 = quad // nk2
        k2 = quad - i2 * nk2
        i, k = 2 * i2 + (c & 1), 2 * k2 + ((c >> 1) & 1)
        ok, src = (i < r1) & (k < r2), (i * n + row) * r2 + k
    v = torch.where(ok, flat[torch.where(ok, src, 0)], torch.zeros(()))
    return v.reshape(n, sched.stride)


def emulate(state, core, idx, sched):
    """The kernel's arithmetic on the CPU: rows of ``pack_rows`` read as
    quads, the bucket's loops with their guards (the generic instance: all
    pairs of ``i``, outputs in tiles of 32), sums over ``i`` in increasing
    order; a zero column for an index outside ``[0, n)``."""
    r1, n, r2 = core.shape
    nnz = idx.shape[0]
    quads = pack_rows(core, sched).reshape(n, sched.stride // 4, 4)
    inside = (idx >= 0) & (idx < n)
    q = quads[idx.clamp(0, n - 1)] * inside[:, None, None]
    if sched.first:
        b2 = sched.r2_bucket or sched.row
        acc = torch.zeros((b2, nnz))
        for qq in range(b2 // 4):
            if qq < sched.row // 4:
                acc[4 * qq: 4 * qq + 4] = q[:, qq].T
        return acc[:r2]
    ni2, nk2 = math.ceil(r1 / 2), math.ceil(r2 / 2)
    generic = sched.r1_bucket == 0
    b1 = 2 * ni2 if generic else sched.r1_bucket
    tile = 32 if generic else sched.r2_bucket
    s = torch.zeros((b1, nnz))
    s[:r1] = state.float()
    out = torch.zeros((r2, nnz))
    for t2 in range(0, nk2, tile // 2):
        acc = torch.zeros((tile, nnz))
        for i2 in range(b1 // 2):
            if i2 >= ni2:
                break
            s0, s1 = s[2 * i2], s[2 * i2 + 1]
            for k2 in range(tile // 2):
                if t2 + k2 < nk2:
                    v = q[:, i2 * nk2 + t2 + k2]
                    acc[2 * k2] = _fma(s0, v[:, 0], acc[2 * k2])
                    acc[2 * k2] = _fma(s1, v[:, 1], acc[2 * k2])
                    acc[2 * k2 + 1] = _fma(s0, v[:, 2], acc[2 * k2 + 1])
                    acc[2 * k2 + 1] = _fma(s1, v[:, 3], acc[2 * k2 + 1])
        hi = min(r2, 2 * t2 + tile)
        out[2 * t2: hi] = acc[: hi - 2 * t2]
    return out


def _operands(r1, n, r2, nnz, seed):
    rng = np.random.default_rng(seed)
    core = rng.standard_normal((r1, n, r2)).astype(np.float32)
    state = rng.standard_normal((r1, nnz)).astype(np.float32)
    idx = rng.integers(0, n, nnz).astype(np.int64)
    idx[:2] = (n - 1, 0)
    return state, core, idx


def _within_ulps(got, ref):
    ref = np.asarray(ref, dtype=np.float32)
    ulp = float(np.abs(ref).max()) * 2.0 ** -23
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= CHAIN_ULPS * ulp, f"{err / ulp:.2f} ulps"


@pytest.mark.parametrize("r1,n,r2,nnz", [
    (1, 183, 10, 700),     # uber's first step
    (10, 24, 10, 1500),    # uber's staged step
    (10, 60, 10, 900),     # the (10, 1140, 10) step's layout, fewer rows
    (4, 37, 4, 600),       # the smallest buckets' edges
    (5, 20, 5, 600),       # one past them
    (9, 30, 13, 800),      # buckets 16 and 16
    (17, 11, 3, 500),      # bucket 32 of the state's rank
    (6, 40, 9, 999),       # phase 10's bfloat16 shape, in float32
    (1, 9, 1, 300),        # ranks of 1 with a state
    (20, 50, 1, 400),      # one output
    (33, 12, 3, 300),      # past the largest bucket: the generic instance
    (3, 12, 33, 300),
    (1, 13, 33, 300),      # the generic first step
])
def test_emulation_matches_reference_and_pallas(r1, n, r2, nnz):
    first = r1 == 1 and n in (183, 13)
    state, core, idx = _operands(r1, n, r2, nnz, seed=r1 * 100 + r2)
    sched = CS.chain_schedule(n, r1, r2, first)
    st = None if first else torch.from_numpy(state)
    got = emulate(st, torch.from_numpy(core), torch.from_numpy(idx), sched)
    ref = CS.chain_step_t_reference(st, torch.from_numpy(core),
                                    torch.from_numpy(idx))
    pallas = JC.chain_step_t(None if first else jnp.asarray(state),
                             jnp.asarray(core),
                             jnp.asarray(idx.astype(np.int32)),
                             interpret=True)
    assert tuple(got.shape) == (r2, nnz) == tuple(pallas.shape)
    if first:
        assert torch.equal(got, ref)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    else:
        _within_ulps(got, ref.numpy())
        _within_ulps(got, pallas)


@pytest.mark.parametrize("n", [ROWS_AT_BUDGET, ROWS_AT_BUDGET + 1, 5000])
def test_emulation_at_the_budget_edges(n):
    """The layout does not depend on where the core lives; the rows at
    the edges are read like any other."""
    state, core, idx = _operands(10, n, 10, 600, seed=n)
    sched = CS.chain_schedule(n, 10, 10, False)
    idx[2:6] = (n - 1, n - 2, 1, 0)
    st, c, i = (torch.from_numpy(a) for a in (state, core, idx))
    _within_ulps(emulate(st, c, i, sched),
                 CS.chain_step_t_reference(st, c, i).numpy())


def test_emulation_zero_columns_outside_the_mode():
    state, core, idx = _operands(6, 40, 9, 1000, seed=5)
    idx[::7] = 40
    idx[3] = -1
    st, c, i = (torch.from_numpy(a) for a in (state, core, idx))
    for first in (False, True):
        cc = c[:1] if first else c
        got = emulate(None if first else st, cc, i,
                      CS.chain_schedule(40, cc.shape[0], 9, first))
        bad = (i < 0) | (i >= 40)
        assert bool((got[:, bad] == 0).all())
        ok = ~bad
        ref = CS.chain_step_t_reference(None if first else st[:, ok], cc,
                                        i[ok])
        if first:
            assert torch.equal(got[:, ok], ref)
        else:
            _within_ulps(got[:, ok], ref.numpy())


def test_pack_rows_layout():
    """A step's quad ``i2 * nk2 + k2`` holds ``c[2i2, 2k2]``,
    ``c[2i2+1, 2k2]``, ``c[2i2, 2k2+1]``, ``c[2i2+1, 2k2+1]``; padding is
    zero."""
    core = torch.arange(3 * 4 * 5, dtype=torch.float32).reshape(3, 4, 5) + 1
    s = CS.chain_schedule(4, 3, 5, False)
    rows = pack_rows(core, s)
    assert tuple(rows.shape) == (4, s.stride) and s.row == 4 * 6
    nk2 = 3
    for row in range(4):
        for i in range(4):
            for k in range(6):
                v = rows[row, (i // 2 * nk2 + k // 2) * 4 + 2 * (k % 2)
                         + i % 2]
                want = core[i, row, k] if i < 3 and k < 5 else 0
                assert float(v) == float(want)
    assert bool((rows[:, s.row:] == 0).all())
    first = pack_rows(core[:1], CS.chain_schedule(4, 1, 5, True))
    assert torch.equal(first[:, :5], core[0]) and bool(
        (first[:, 5:] == 0).all())


def test_bfloat16_core_packs_exactly():
    core = torch.randn((1, 30, 7)).to(torch.bfloat16)
    rows = pack_rows(core, CS.chain_schedule(30, 1, 7, True))
    assert rows.dtype == torch.float32
    assert torch.equal(rows[:, :7].to(torch.bfloat16), core[0])


# -- 3. the constants the wrapper shares with the kernel ----------------------

def _array(name):
    m = re.search(rf"constexpr int {name}\[\] = \{{([\d, ]+)\}};", SRC)
    assert m, f"{name} not found in chain_step.cu"
    return tuple(int(v) for v in m.group(1).split(","))


def _const(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, f"{name} not found in chain_step.cu"
    return int(m.group(1))


def test_constants_match_the_kernel():
    assert _array("R1_BUCKETS") == CS.R1_BUCKETS
    assert _array("R2_BUCKETS") == CS.R2_BUCKETS
    assert _const("THREADS") == CS.THREADS
    # the kernel instantiates every bucket: a `case` of its dispatch each
    for b in CS.R2_BUCKETS:
        assert f"case {b}: return by_place<FIRST, B1, {b}>" in SRC
    for b in CS.R1_BUCKETS:
        assert f"by_r2<false, {b}>(a, r2_bucket" in SRC
    assert CS.PLACES == {"block": 0, "cache": 1}
    assert "PLACE_BLOCK = 0, PLACE_CACHE = 1" in SRC
    # two blocks an SM: 233,472 bytes of shared memory, 1 KB kept per block
    assert 2 * (CS.BLOCK_BUDGET + 1024) <= 233472
