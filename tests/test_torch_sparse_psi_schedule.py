"""What the block program of ``tt_sketch_torch/csrc/sparse_psi.cu`` relies
on, pinned on the CPU (the kernel itself runs only on the card).

1. The plans: ``loc`` is non-decreasing inside every chunk of a
   ``ModePlan`` and over every window's run of a ``WindowPlan``, with the
   pads (``loc == span``, entry 0) only at the end.  The kernel carries a
   run's sum across tiles and stores it once, when its row changes.
2. A numpy emulation of the schedule: the block's range cut into thread
   groups of whole sub-tiles, the tile columns past a group's range (zero
   rows, the group's last row), the micro-tiles ``(i, {jq + c·NJ})`` of
   each thread, the run sums carried across tiles, each group's head and
   tail runs and Ω sums added in group order, and passes when the
   micro-tiles outnumber the threads.  Every slab and Ω element is stored
   exactly once (or left at the zero pass's zero), and the sums equal the
   plain versions at ``PSI_TOL`` (2e-5 relative Frobenius, as on the card:
   float32 sums in another order).
3. The shared-memory layout: every call the wrappers' limit admits fits
   the kernel's tiles and its combine, and the row stride keeps eight
   consecutive rows in eight bank quads.
4. The given-rows instances (``psi_chunk_slabs``,
   ``psi_chunk_slabs_genright``), emulated: their schedule (stride, groups,
   ring depth for the blocks the card holds) and layout, the copy ring
   (tile j in stage j % NS, issued NS - 1 tiles ahead, a stage read only
   for the tile it holds), each group's segment copied in 16-byte quads
   where its source is 16-byte aligned and one value at a time where not
   (every nnz % 4, unaligned e and loc, operands whose first element is
   unaligned), never a read past the range, the entries folded into the
   B quads, the group's last row past its range; against the plain
   versions and the Pallas kernels in interpret mode, at the side
   combinations, the micro-tile's edges, sentinel tiles, a one-row chunk
   and sign and sliced hashed sides.  The schedules of the recorded calls
   are pinned to what the card printed.

The constants are read from the kernel source, so the emulation follows
it.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tt_sketch_torch import config
from tt_sketch_torch.kernels import sparse_psi as SP
from tt_sketch_torch.kernels.sparse_plan import (
    ModePlan,
    WindowPlan,
    build_psi_plan,
)
from tt_sketch_torch.rng.hash_rng import drm_salts

SRC = (Path(__file__).resolve().parents[1] / "tt_sketch_torch" / "csrc"
       / "sparse_psi.cu").read_text()


def _const(name):
    m = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", SRC)
    assert m, f"{name} not found in sparse_psi.cu"
    return int(m.group(1))


THREADS, MJ, GMAX = (_const(n) for n in ("THREADS", "MJ", "GMAX"))
STRIDES = tuple(int(v) for v in re.search(
    r"constexpr int STRIDES\[\] = \{([\d, ]+)\};", SRC).group(1).split(","))
OMEGA_CHUNK, SMEM_LIMIT = _const("OMEGA_CHUNK"), _const("SMEM_LIMIT")
PSI_TOL = 2e-5
SHAPE = (11, 9, 300, 25)
GAUSS = ("g",)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("TT_SKETCH_TPU_FORCE_TPU", "1")
    monkeypatch.setenv("TT_SKETCH_TPU_PALLAS_INTERPRET", "1")


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _data(nnz=1500, seed=23, shape=SHAPE, skew_mode=2):
    """Random COO data with hot rows and a gap in ``skew_mode``."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape]).astype(np.int64)
    n = shape[skew_mode]
    idx[skew_mode] = np.where(rng.random(nnz) < 0.5,
                              rng.integers(0, max(n // 15, 1), nnz),
                              rng.integers(n - n // 6, n, nnz))
    return idx, rng.standard_normal(nnz).astype(np.float32)


def _plans(threshold=8, **kw):
    idx, ent = _data()
    return build_psi_plan(idx, SHAPE, threshold=threshold, entries=ent,
                          device="cpu", **kw), ent.shape[0]


# -- 1. plan invariants ----------------------------------------------------------

PLAN_CASES = {
    "threshold 8": dict(threshold=8),
    "threshold 12": dict(threshold=12),
    "threshold 8, chunk 100": dict(threshold=8, chunk=100),
    "forced windows": dict(threshold=8, window_threshold=100,
                           window_span=32),
}


@pytest.mark.parametrize("case", PLAN_CASES, ids=list(PLAN_CASES))
def test_loc_is_non_decreasing_with_pads_last(case):
    plans, nnz = _plans(**PLAN_CASES[case])
    seen = set()
    for plan in plans:
        if plan is None:
            continue
        seen.add(type(plan).__name__)
        loc = plan.local_idx.numpy()
        span, chunk = plan.span, plan.chunk
        if isinstance(plan, ModePlan):
            assert (loc[:nnz] < span).all() and (loc[nnz:] == span).all()
            for c in range(plan.n_chunks):
                run = loc[c * chunk:min((c + 1) * chunk, nnz)]
                assert (np.diff(run) >= 0).all()
        else:
            ent = plan.sorted_entries.numpy()
            win = plan.chunk_window.numpy()
            for w in np.unique(win):
                cs = np.flatnonzero(win == w)
                assert (np.diff(cs) == 1).all()
                run = loc[cs[0] * chunk:(cs[-1] + 1) * chunk]
                assert (np.diff(run) >= 0).all()
                pads = run == span
                n_real = int((~pads).sum())
                assert pads[n_real:].all() and not pads[:n_real].any()
                seg = ent[cs[0] * chunk:(cs[-1] + 1) * chunk]
                assert (seg[pads] == 0).all()
    expect = {"WindowPlan", "ModePlan"} if "windows" in case else {"ModePlan"}
    assert seen == expect


# -- 2. the schedule, emulated ---------------------------------------------------

def layout_bytes(ts, g, rows, salts, ne, neo):
    """``Layout::bytes`` of the kernel source: the tiles (rows, loc, each
    thread's parked sums and run, salts) or the groups' tails and Ω sums
    over them, then the group heads."""
    park = THREADS * (16 * (2 if neo else 1) + 8)
    tiles = rows * ts * 4 + ts * 4 + park + salts * 8
    tails = g * (ne + neo) * 4 if g > 1 else 0
    heads = -(-max(tiles, tails) // 16) * 16
    return heads + (g * (8 + 4 * ne) if g > 1 and ne else 0)


def schedule(psi, om, r1, r2, r1o, rows=None, salts=None, draws=()):
    """(TS, G, TG, NA, P, GP, BYI) as ``schedule`` of the kernel source, for
    ``rows`` allocated and ``salts`` held (default: Gaussian sides);
    ``draws`` lists the sign sides' draws: a side takes a thread per
    (most draws // its draws) tile columns from a warp of its own, and all
    must fit the block."""
    rows = (r1 if psi else 0) + r2 + r1o if rows is None else rows
    salts = rows if salts is None else salts
    byi = psi and not om and r2 < MJ and r1 > r2
    m = max(r1 if psi else 0, r1o if om else 0)
    na = -(-(r1 if byi else r2) // MJ)
    p = (r2 if byi else m) * na
    g = 1 if 2 * p > THREADS else min(THREADS // p, GMAX)
    for ts in STRIDES:
        tg = ts // (4 * g) * 4
        most, used = max(draws, default=1), 0
        for d in draws:  # each side from a warp of its own
            used = -(-used // 32) * 32 + -(-g * tg // (most // d))
        if used <= THREADS and layout_bytes(
                ts, g, rows, salts, r1 * r2 if psi else 0,
                r1o * r2 if om else 0) <= SMEM_LIMIT:
            break
    return ts, g, tg, na, p, (p if g > 1 else THREADS), byi


def run_block(loc, L, R, O, start, end, span):
    """One block of the kernel over ``[start, end)`` of the stream: ``L``
    (r1, N) and ``O`` (r1o, N) carry the entries, ``R`` (r2, N); ``L`` or
    ``O`` None switches Ψ or Ω off.  Returns the slab (span, r1, r2), its
    stores per element after the zero pass, Ω (r1o, r2) and its stores."""
    psi, om = L is not None, O is not None
    r1 = L.shape[0] if psi else 1
    r2 = R.shape[0]
    r1o = O.shape[0] if om else 0
    _, G, TG, NA, P, GP, byi = schedule(psi, om, r1, r2, r1o)
    A, n_a = (L, r1) if byi else (R, r2)
    slab = np.zeros((span, r1, r2), np.float32)  # the zero pass
    slab_n = np.zeros((span, r1, r2), np.int64)
    om_out = np.full((max(r1o, 1), r2), np.nan, np.float32)
    om_n = np.zeros((max(r1o, 1), r2), np.int64)
    n = max(end - start, 0)
    q = -(-n // G)
    q = -(-q // TG) * TG
    n_it = q // TG
    passes = -(-P // GP)
    ends, heads, tails, oms = [], [], [], []
    for pas in range(passes):
        for grp in range(G):
            ps = np.arange(pas * GP, min(P, pas * GP + GP))
            b = ps // NA  # the B row; A rows a0 + c·NA
            ac = (ps % NA)[:, None] + np.arange(MJ)[None, :] * NA
            aok = ac < n_a
            arow = np.where(aok, ac, 0)
            # output c of a micro-tile: (i, j) = (b, a_c), or (a_c, b) by i
            ic, jc = (arow, b[:, None] + 0 * ac) if byi else \
                (b[:, None] + 0 * ac, arow)
            bl, bo = np.where(b < r1, b, 0), np.where(b < r1o, b, 0)
            psi_b = psi & (byi | (b < r1))
            om_b = om & (b < r1o)
            lo = start + grp * q
            hi = min(lo + q, end)
            my_n = max(hi - lo, 0)
            acc = np.zeros((ps.size, MJ), np.float32)
            oacc = np.zeros_like(acc)
            st = {"s": int(loc[lo]) if psi and my_n else 0, "head_row": -1,
                  "head": np.zeros_like(acc), "open": True}

            def store(s, vals):
                if 0 <= s < span:
                    for c in range(MJ):
                        sel = psi_b & aok[:, c]
                        slab[s, ic[sel, c], jc[sel, c]] = vals[sel, c]
                        slab_n[s, ic[sel, c], jc[sel, c]] += 1

            def close(nxt):
                if G > 1 and st["open"]:
                    st["head_row"], st["head"] = st["s"], acc.copy()
                else:
                    store(st["s"], acc)
                st["open"] = False
                acc[:] = 0
                st["s"] = nxt

            for it in range(n_it):
                if it * TG >= my_n:
                    continue
                ks = lo + it * TG + np.arange(TG)
                kv = ks < hi
                kc = np.where(kv, ks, hi - 1)
                lcol = np.where(kv, loc[kc] if psi else 0,
                                loc[hi - 1] if psi else 0)
                At = np.where(kv, A[:, kc], 0).astype(np.float32)
                av = At[arow] * aok[:, :, None]  # (np, MJ, TG)
                if byi:
                    Bt = np.where(kv, R[:, kc], 0).astype(np.float32)[b]
                elif psi:
                    Bt = np.where(kv, L[:, kc], 0).astype(np.float32)[bl]
                Ot = np.where(kv, O[:, kc], 0).astype(np.float32)[bo] if om \
                    else None
                for t in range(0, TG, 4):
                    if om:
                        for v in range(4):
                            oacc += Ot[:, t + v][:, None] * av[:, :, t + v]
                    if psi:
                        lc = lcol[t:t + 4]
                        same = lc[3] == st["s"]  # the four continue the run
                        for v in range(4):
                            if not same and lc[v] != st["s"]:
                                close(int(lc[v]))
                            acc += Bt[:, t + v][:, None] * av[:, :, t + v]
            if G == 1:
                if psi and my_n:
                    close(st["s"])
                if om:
                    for c in range(MJ):
                        sel = om_b & aok[:, c]
                        om_out[ic[sel, c], jc[sel, c]] = oacc[sel, c]
                        om_n[ic[sel, c], jc[sel, c]] += 1
                continue
            # group partials, as the kernel writes them to shared memory
            h = np.full((r1, r2), np.nan, np.float32)
            tl = np.full((r1, r2), np.nan, np.float32)
            o = np.full((max(r1o, 1), r2), np.nan, np.float32)
            for c in range(MJ):
                sel = psi_b & aok[:, c]
                assert np.isnan(h[ic[sel, c], jc[sel, c]]).all()
                h[ic[sel, c], jc[sel, c]] = (acc if st["open"]
                                             else st["head"])[sel, c]
                tl[ic[sel, c], jc[sel, c]] = acc[sel, c]
                sel = om_b & aok[:, c]
                o[ic[sel, c], jc[sel, c]] = oacc[sel, c]
            ends.append((-1 if not my_n else st["s"] if st["open"]
                         else st["head_row"],
                         -1 if not my_n or st["open"] else st["s"]))
            heads.append(h)
            tails.append(tl)
            oms.append(o)
    if G > 1:
        if psi:
            assert not np.isnan(np.stack(heads)).any()
            cur, total = -1, None
            for (hr, tr), h, tl in zip(ends, heads, tails):
                for row, vals in ((hr, h), (tr, tl)):
                    if row < 0:
                        continue
                    if row == cur:
                        total = total + vals
                    else:
                        if 0 <= cur < span:
                            slab[cur] = total
                            slab_n[cur] += 1
                        cur, total = row, vals.copy()
            if 0 <= cur < span:
                slab[cur] = total
                slab_n[cur] += 1
        if om:
            om_out = oms[0].copy()
            for o in oms[1:]:
                om_out = om_out + o
            om_n += 1
    return slab, slab_n, om_out[:r1o], om_n[:r1o]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _side(plan, which, r, seed, n, ent):
    """(flat, salts, rows (r, n)) of one hashed Gaussian side, or Nones."""
    flat = getattr(plan, which)
    if flat is None or r == 0:
        return None, None, None
    salts = drm_salts(0, r, seed)
    weight = ent if which != "flat_right" else None
    return flat, salts, SP._rows(flat, salts, GAUSS, n, ent, weight).numpy()


RANKS = {"1x1": (1, 1), "7x13": (7, 13), "10x20": (10, 20),
         "16x16": (16, 16), "30x40 (passes)": (30, 40)}


def _mode_plan(mu, chunk=None):
    plans, nnz = _plans(threshold=8, chunk=chunk)
    plan = plans[mu]
    assert isinstance(plan, ModePlan)
    return plan, nnz


@pytest.mark.parametrize("chunk", [None, 100], ids=["plan chunk", "chunk 100"])
@pytest.mark.parametrize("ranks", RANKS, ids=list(RANKS))
def test_merged_schedule_stores_once_and_sums(ranks, chunk):
    r1, r2 = RANKS[ranks]
    plan, nnz = _mode_plan(1, chunk)
    ent = plan.sorted_entries
    lflat, lsalts, L = _side(plan, "flat_left", r1, 5, nnz, ent)
    rflat, rsalts, R = _side(plan, "flat_right", r2, 6, nnz, ent)
    oflat, osalts, O = _side(plan, "flat_left_om", r1, 7, nnz, ent)
    loc = plan.local_idx.numpy()
    ref_slabs, ref_om = SP.psi_omega_merged_slabs_reference(
        plan.local_idx, ent, lflat, rflat, oflat, lsalts, rsalts, osalts,
        plan.n_chunks, plan.span, plan.chunk)
    slabs, om = [], np.zeros((r1, r2), np.float32)
    for g in range(plan.n_chunks):
        start = g * plan.chunk
        s, sn, o, on = run_block(loc, L, R, O, start,
                                 min(start + plan.chunk, nnz), plan.span)
        assert sn.max() <= 1 and (on == 1).all()
        assert (s[sn == 0] == 0).all()
        slabs.append(s)
        om = om + o
    assert _rel(np.stack(slabs), ref_slabs.numpy()) <= PSI_TOL
    assert _rel(om, ref_om.numpy()) <= PSI_TOL
    if chunk is None:
        # a run crosses a tile boundary inside a group's part of chunk 0
        G, TG = schedule(True, True, r1, r2, r1)[1:3]
        n = min(plan.chunk, nnz)
        q = -(-(-(-n // G)) // TG) * TG
        cuts = [b for g in range(G) for b in range(g * q + TG, min(
            (g + 1) * q, n), TG)]
        assert any(loc[b - 1] == loc[b] for b in cuts)


def test_merged_schedule_without_a_left_side():
    # mode 0: Ψ's left side is a row of ones, Ω has r1o = 10 rows
    plan, nnz = _mode_plan(0)
    ent = plan.sorted_entries
    rflat, rsalts, R = _side(plan, "flat_right", 20, 6, nnz, ent)
    oflat, osalts, O = _side(plan, "flat_left_om", 10, 7, nnz, ent)
    L = ent.numpy()[None, :]
    ref_slabs, ref_om = SP.psi_omega_merged_slabs_reference(
        plan.local_idx, ent, None, rflat, oflat, None, rsalts, osalts,
        plan.n_chunks, plan.span, plan.chunk)
    loc = plan.local_idx.numpy()
    slabs, om = [], 0
    for g in range(plan.n_chunks):
        start = g * plan.chunk
        s, sn, o, on = run_block(loc, L, R, O, start,
                                 min(start + plan.chunk, nnz), plan.span)
        assert sn.max() <= 1 and (on == 1).all()
        slabs.append(s)
        om = om + o
    assert _rel(np.stack(slabs), ref_slabs.numpy()) <= PSI_TOL
    assert _rel(om, ref_om.numpy()) <= PSI_TOL


@pytest.mark.parametrize("ranks", RANKS, ids=list(RANKS))
def test_omega_schedule_stores_once_and_sums(ranks):
    r1, r2 = RANKS[ranks]
    plan, nnz = _mode_plan(1)
    ent = plan.sorted_entries
    lflat, lsalts, L = _side(plan, "flat_left_om", r1, 7, nnz, ent)
    rflat, rsalts, R = _side(plan, "flat_right", r2, 6, nnz, ent)
    ref = SP.omega_fused_reference(ent, lflat, rflat, lsalts, rsalts)
    # the kernel's blocks of OMEGA_CHUNK nnz, shrunk so that several run
    chunk = min(OMEGA_CHUNK, 256)
    om = 0
    for start in range(0, nnz, chunk):
        _, _, o, on = run_block(None, None, R, L, start,
                                min(start + chunk, nnz), 1)
        assert (on == 1).all()
        om = om + o
    assert _rel(om, ref.numpy()) <= PSI_TOL


@pytest.mark.parametrize("ranks", [(10, 20), (7, 13), (10, 1)],
                         ids=["10x20", "7x13", "10x1 (no right side)"])
def test_window_schedule_stores_once_and_sums(ranks):
    r1, r2 = ranks
    plans, _ = _plans(threshold=8, window_threshold=100, window_span=32)
    mu = 2
    plan = plans[mu]
    assert isinstance(plan, WindowPlan)
    n_pad = plan.n_chunks * plan.chunk
    ent = plan.sorted_entries
    lflat, lsalts, L = _side(plan, "flat_left", r1, 5, n_pad, ent)
    if r2 == 1:
        rflat = rsalts = None
        R = np.ones((1, n_pad), np.float32)
    else:
        rflat, rsalts, R = _side(plan, "flat_right", r2, 6, n_pad, ent)
    loc = plan.local_idx.numpy()
    win = plan.chunk_window.numpy()
    first = plan.chunk_first.numpy()
    ref = SP.psi_window_direct_reference(
        plan.chunk_window, plan.chunk_first, plan.local_idx, ent, lflat,
        rflat, lsalts, rsalts, plan.n_chunks, plan.span, plan.chunk,
        plan.n_windows)
    out, spanning = [], False
    for w in range(plan.n_windows):
        # the kernel's range: the window's chunks, cut at its first pad
        lo = int(np.searchsorted(win, w))
        c1 = lo
        if lo < plan.n_chunks and win[lo] == w:
            c1 = lo + 1
            while c1 < plan.n_chunks and first[c1] == 0:
                c1 += 1
        start, end = lo * plan.chunk, c1 * plan.chunk
        end = start + int(np.searchsorted(loc[start:end], plan.span))
        spanning |= c1 - lo > 1 and end > (lo + 1) * plan.chunk
        s, sn, _, _ = run_block(loc, L, R, None, start, end, plan.span)
        assert sn.max() <= 1
        out.append(s)
    assert spanning, "no window's run crosses a chunk boundary"
    got = np.concatenate(out).reshape(ref.shape)
    assert _rel(got, ref.numpy()) <= PSI_TOL


@pytest.mark.parametrize("ranks,expect", [
    ((10, 20, 10), (252, 5, 48, 5, 50, False)),
    ((1, 1, 0), (252, 15, 16, 1, 1, False)),
    ((16, 16, 0), (252, 4, 60, 4, 64, False)),
    ((30, 40, 0), (252, 1, 252, 10, 300, False)),
    ((1, 20, 10), (252, 5, 48, 5, 50, False)),
    ((10, 1, 0), (252, 15, 16, 3, 3, True))],
    ids=["merged 10x20", "1x1", "16x16", "30x40", "merged, no left side",
         "10x1, by the left side"])
def test_schedule_fills_the_block(ranks, expect):
    r1, r2, r1o = ranks
    ts, G, TG, NA, P, GP, byi = schedule(True, r1o > 0, r1, r2, r1o)
    assert (ts, G, TG, NA, P, byi) == expect
    assert TG % 4 == 0 and G * TG <= ts
    assert G * GP <= THREADS or G == 1


# -- 3. shared memory ------------------------------------------------------------

LIMIT_CASES = {
    # (rows allocated, salts, sign sides' draws, (r1, r2, r1o)): the stride
    "sign 433 + 433, 3 x 3": ((866, 866, (433, 433), (3, 3, 0)), 60),
    "given 892 + 1": ((893, 0, (), (892, 1, 0)), 60),
    "merged sign 288 x 3": ((864, 864, (288,) * 3, (3, 3, 3)), 60),
    "merged gauss 10 x 20 + 10": ((40, 40, (), (10, 20, 10)), 252),
    "merged sign 10 x 20 + 10": ((40, 40, (20, 10, 10), (10, 20, 10)), 124),
    "merged sign, equal draws": ((60, 60, (20, 20, 20), (10, 20, 10)), 60),
    "omega sign 10 x 20": ((30, 30, (20, 10), (1, 20, 10)), 172),
    "psi sign 10, no right side": ((11, 10, (10,), (10, 1, 0)), 252),
    "gauss 200 + 200": ((400, 400, (), (200, 200, 0)), 124),
    "gauss 235 + 235": ((470, 470, (), (235, 235, 0)), 84),
}


@pytest.mark.parametrize("case", LIMIT_CASES, ids=list(LIMIT_CASES))
def test_kernel_layout_fits_the_wrappers_limit(case):
    (rows, salts, draws, (r1, r2, r1o)), stride = LIMIT_CASES[case]
    api = 8 * salts + 4 * (64 + 1) * rows + 4 * 64
    assert api <= SMEM_LIMIT  # what the wrappers admit
    psi = "omega" not in case  # omega_fused: Ψ off, Ω's left side r1o
    ts, G = schedule(psi, r1o > 0, r1, r2, r1o, rows, salts, draws)[:2]
    assert ts == stride
    assert layout_bytes(ts, G, rows, salts, r1 * r2 if psi else 0,
                        r1o * r2) <= SMEM_LIMIT


@pytest.mark.parametrize("ts", STRIDES)
def test_row_stride_spreads_eight_rows_over_the_bank_quads(ts):
    assert ts % 4 == 0
    for r in range(64):
        quads = {((r + d) * ts // 4) % 8 for d in range(8)}
        assert len(quads) == 8


# -- 4. the given-rows instances, emulated -----------------------------------------

RING = _const("RING")
MIN_BLOCKS_GIVEN = int(re.search(r"MIN_BLOCKS_GIVEN = (\d+)", SRC).group(1))
#: the card's SMs, shared memory an SM and reserved a block (NVIDIA H100 80GB
#: HBM3; the kernel reads them from the device)
N_SM, SM_BYTES, RESERVED = 132, 233472, 1024
GV_LEFT, GV_RIGHT = 1, 2


def given_layout_bytes(ts, g, ns, r1, r2, nst, rows_r, salts_r):
    """``Layout::bytes`` of a given-rows instance: the hashed right side's
    rows, the parked sums and runs, its salts, then ``ns`` ring stages of
    ``nst`` rows; the groups' tails over them, then the heads."""
    ne = r1 * r2
    ring = -(-(rows_r * ts * 4 + THREADS * (16 + 8) + salts_r * 8) // 16) * 16
    tiles = ring + ns * nst * ts * 4
    tails = g * ne * 4 if g > 1 else 0
    heads = -(-max(tiles, tails) // 16) * 16
    return heads + (g * (8 + 4 * ne) if g > 1 else 0)


def given_schedule(r1, r2, has_l, has_r, gv, n_blocks, rows_r=0, salts_r=0):
    """``schedule_given`` of the kernel source: (TS, G, TG, NS, NA, P, GP,
    BYI, nst) for ``n_blocks`` blocks on the card (``rows_r``/``salts_r``:
    a hashed right side's rows allocated and salts; a hashed side takes one
    stage, its hashing hides the copies)."""
    byi = not has_r or (r2 < MJ and r1 > r2)
    na = -(-(r1 if byi else r2) // MJ)
    p = (r2 if byi else r1) * na
    g = 1 if 2 * p > THREADS else min(THREADS // p, GMAX)
    gp = p if g > 1 else THREADS
    nst = (r1 if has_l else 0) + (r2 if gv == GV_RIGHT and has_r else 0) + 2
    hashed = gv == GV_LEFT and has_r
    want = min(-(-n_blocks // N_SM), MIN_BLOCKS_GIVEN)
    for b in range(max(want, 1), 0, -1):
        budget = min(SM_BYTES // b - RESERVED, SMEM_LIMIT)
        for ts in STRIDES:
            tg = ts // (4 * g) * 4
            for ns in ((1,) if hashed else range(RING, 1, -1)):
                if given_layout_bytes(ts, g, ns, r1, r2, nst, rows_r,
                                      salts_r) <= budget:
                    return ts, g, tg, ns, na, p, gp, byi, nst
    ts = STRIDES[-1]
    return ts, g, ts // (4 * g) * 4, 1, na, p, gp, byi, nst


class Ring:
    """The copy ring of one block: ``ns`` stages of ``nst`` rows of ``ts``
    floats (NaN until a copy lands), each tagged with the tile it holds;
    counts the copies by kind."""

    def __init__(self, ns, nst, ts):
        self.buf = np.full((ns, nst, ts), np.nan, np.float32)
        self.tile = np.full(ns, -1)
        self.copies = {"16": 0, "4": 0, "zero": 0}

    def stage(self, j, sources, start, end, q, G, TG):
        """Tile ``j`` into stage ``j % ns`` as ``stage_tile`` does:
        ``sources`` per stage row ``(array, offset, base)`` (row r of a
        given side is ``array`` from element ``offset = r * nnz``; ``base``
        the array's first element's misalignment in elements).  Each
        group's segment goes in quads: one 16-byte copy where the source is
        16-byte aligned (the rest zero-filled), else 4-byte copies of the
        columns in range; a segment past the group's range is skipped."""
        st = self.buf[j % len(self.tile)]
        self.tile[j % len(self.tile)] = j
        for row, (arr, offset, base) in enumerate(sources):
            for gc in range(G):
                k0 = start + gc * q + j * TG
                left = min(start + (gc + 1) * q, end) - k0
                if left <= 0:
                    continue
                for qd in range(TG // 4):
                    src = offset + k0 + 4 * qd
                    nv = left - 4 * qd
                    dst = st[row, gc * TG + 4 * qd: gc * TG + 4 * qd + 4]
                    if nv <= 0:
                        dst[:] = 0
                        self.copies["zero"] += 1
                    elif (base + src) % 4 == 0:
                        n = min(nv, 4)
                        assert src + n <= arr.shape[0]  # reads in range only
                        dst[:] = 0
                        dst[:n] = arr[src:src + n]
                        self.copies["16"] += 1
                    else:
                        n = min(nv, 4)
                        assert src + n <= arr.shape[0]
                        dst[:] = 0
                        dst[:n] = arr[src:src + n]
                        self.copies["4"] += n


def run_given_block(loc, e, L, R, start, end, span, nnz, gv, n_blocks,
                    R_hashed=None, bases=(0, 0, 0, 0)):
    """One block of a given-rows instance over ``[start, end)``: ``L``
    (r1, nnz) given left rows or None, ``R`` (r2, nnz) given right rows
    (``gv == GV_RIGHT``) or None, ``R_hashed`` (r2, nnz) the right rows a
    ``GV_LEFT`` instance hashes into its tile; ``bases``: the
    misalignment in elements of L, R, e and loc.  The ring as the kernel
    runs it (NS - 1 tiles ahead, a stage read only for the tile it
    holds), e folded into the B quads (a missing side is B, and then B is
    e), past a group's range its last row repeated.  Returns the slab
    (span, r1, r2), its stores per element after the zero pass, the
    schedule and the ring's copy counts."""
    has_l = L is not None
    has_r = R is not None or R_hashed is not None
    r1 = L.shape[0] if has_l else 1
    r2 = (R if R is not None else R_hashed).shape[0] if has_r else 1
    TS, G, TG, NS, NA, P, GP, byi, nst = given_schedule(
        r1, r2, has_l, has_r, gv, n_blocks,
        rows_r=r2 if R_hashed is not None else 0,
        salts_r=r2 if R_hashed is not None else 0)
    sources = ([(L.reshape(-1), r * nnz, bases[0]) for r in range(r1)]
               if has_l else [])
    if R is not None:
        sources += [(R.reshape(-1), r * nnz, bases[1]) for r in range(r2)]
    sources += [(e, 0, bases[2]), (loc.view(np.float32), 0, bases[3])]
    assert len(sources) == nst
    slab = np.zeros((span, r1, r2), np.float32)  # the zero pass
    slab_n = np.zeros((span, r1, r2), np.int64)
    n = max(end - start, 0)
    q = -(-n // G)
    q = -(-q // TG) * TG
    n_it = q // TG
    ring = Ring(NS, nst, TS)
    ends, heads, tails = [], [], []
    passes = -(-P // GP)
    for pas in range(passes):
        accs = {}
        st_g = {}
        for grp in range(G):
            lo = start + grp * q
            hi = min(lo + q, end)
            ps = np.arange(pas * GP, min(P, pas * GP + GP))
            accs[grp] = np.zeros((ps.size, MJ), np.float32)
            st_g[grp] = {"s": int(loc[lo]) if hi > lo else 0,
                         "open": True, "head_row": -1,
                         "head": np.zeros((ps.size, MJ), np.float32),
                         "my_n": max(hi - lo, 0), "lo": lo, "hi": hi,
                         "last": int(loc[hi - 1]) if hi > lo else 0}
        for j in range(NS - 1):
            if j < n_it:
                ring.stage(j, sources, start, end, q, G, TG)
        for it in range(n_it):
            if it + NS - 1 < n_it:
                ring.stage(it + NS - 1, sources, start, end, q, G, TG)
            stg = it % NS
            assert ring.tile[stg] == it  # the stage holds this tile
            rows = ring.buf[stg]
            e_t = rows[nst - 2]
            loc_t = rows[nst - 1].view(np.int32)
            for grp in range(G):
                g_st = st_g[grp]
                if it * TG >= g_st["my_n"]:
                    continue
                in_tile = min(TG, g_st["my_n"] - it * TG)
                cols = slice(grp * TG, grp * TG + TG)
                ps = np.arange(pas * GP, min(P, pas * GP + GP))
                b = ps // NA
                ac = (ps % NA)[:, None] + np.arange(MJ)[None, :] * NA
                aok = ac < (r1 if byi else r2)
                arow = np.where(aok, ac, 0)
                # A and B rows of the tile: staged, hashed, or e itself
                Lt = rows[:r1, cols] if has_l else None
                if R is not None:
                    Rt = rows[(r1 if has_l else 0):(r1 if has_l else 0) + r2,
                              cols]
                elif R_hashed is not None:
                    k = g_st["lo"] + it * TG + np.arange(TG)
                    kv = k < g_st["hi"]
                    Rt = np.where(kv, R_hashed[:, np.minimum(k, nnz - 1)],
                                  0).astype(np.float32)
                else:
                    Rt = None
                et = e_t[cols]
                if byi:
                    At = Lt[arow]
                    Bt = et[None, :] if Rt is None else (Rt[b] * et)
                else:
                    At = Rt[arow]
                    Bt = et[None, :] if Lt is None else (Lt[b] * et)
                Bt = np.broadcast_to(Bt, (ps.size, TG)).astype(np.float32)
                lc = loc_t[cols].copy()
                lc[in_tile:] = g_st["last"]
                acc = accs[grp]
                aok_f = aok[:, :, None]
                for t in range(0, TG, 4):
                    same = lc[t + 3] == g_st["s"]
                    for v in range(4):
                        if not same and lc[t + v] != g_st["s"]:
                            # close the run of row s
                            if G > 1 and g_st["open"]:
                                g_st["head_row"] = g_st["s"]
                                g_st["head"] = acc.copy()
                            else:
                                _store_given(slab, slab_n, g_st["s"], acc,
                                             b, arow, aok, byi, span)
                            g_st["open"] = False
                            acc[:] = 0
                            g_st["s"] = int(lc[t + v])
                        acc += np.where(aok_f[:, :, 0],
                                        Bt[:, t + v][:, None]
                                        * At[:, :, t + v], 0)
        for grp in range(G):
            g_st = st_g[grp]
            acc = accs[grp]
            ps = np.arange(pas * GP, min(P, pas * GP + GP))
            b = ps // NA
            ac = (ps % NA)[:, None] + np.arange(MJ)[None, :] * NA
            aok = ac < (r1 if byi else r2)
            arow = np.where(aok, ac, 0)
            if G == 1:
                if g_st["my_n"]:
                    _store_given(slab, slab_n, g_st["s"], acc, b, arow, aok,
                                 byi, span)
                continue
            h = np.full((r1, r2), np.nan, np.float32)
            tl = np.full((r1, r2), np.nan, np.float32)
            src_h = acc if g_st["open"] else g_st["head"]
            for c in range(MJ):
                i, k = (arow[:, c], b) if byi else (b, arow[:, c])
                sel = aok[:, c]
                h[i[sel], k[sel]] = src_h[sel, c]
                tl[i[sel], k[sel]] = acc[sel, c]
            my_n = g_st["my_n"]
            ends.append((-1 if not my_n else g_st["s"] if g_st["open"]
                         else g_st["head_row"],
                         -1 if not my_n or g_st["open"] else g_st["s"]))
            heads.append(h)
            tails.append(tl)
    if G > 1:
        cur, total = -1, None
        for (hr, tr), h, tl in zip(ends, heads, tails):
            for row, vals in ((hr, h), (tr, tl)):
                if row < 0:
                    continue
                if row == cur:
                    total = total + vals
                else:
                    if 0 <= cur < span:
                        slab[cur] = total
                        slab_n[cur] += 1
                    cur, total = row, vals.copy()
        if 0 <= cur < span:
            slab[cur] = total
            slab_n[cur] += 1
    return slab, slab_n, (TS, G, TG, NS), ring.copies


def _store_given(slab, slab_n, s, acc, b, arow, aok, byi, span):
    """A run's sums stored once, at row ``s`` (the sentinel is never
    written)."""
    if not 0 <= s < span:
        return
    for c in range(MJ):
        sel = aok[:, c]
        i, k = (arow[sel, c], b[sel]) if byi else (b[sel], arow[sel, c])
        slab[s, i, k] = acc[sel, c]
        slab_n[s, i, k] += 1


def _given_plan(nnz, chunk, seed=41, mu=2):
    """The JAX package's plan of mode ``mu`` of a random tensor with
    ``nnz`` nonzeros, and the port's copy of it."""
    from tt_sketch_torch.interop import mode_plan_from_numpy
    from tt_sketch_tpu.kernels.sparse_plan import build_psi_plan as j_build

    idx, ent = _data(nnz=nnz, seed=seed)
    jp = j_build(idx, SHAPE, entries=ent, threshold=8, chunk=chunk)[mu]
    p = mode_plan_from_numpy(
        np.asarray(jp.perm), np.asarray(jp.local_idx),
        np.asarray(jp.slot_rows), jp.n_chunks, jp.span, jp.chunk,
        sorted_entries=np.asarray(jp.sorted_entries),
        flat_left=jp.flat_left, flat_right=jp.flat_right,
        flat_left_om=jp.flat_left_om, gather_slots=jp.gather_slots,
        device="cpu")
    return jp, p


def run_given(p, sl, sr, n_blocks=None, gv=GV_RIGHT, R_hashed=None,
              loc=None, bases=(0, 0, 0, 0)):
    """Every block of a given-rows call over the port's plan ``p``; the
    schedule as for ``n_blocks`` blocks (default: the plan's chunks)."""
    nnz = p.sorted_entries.shape[0]
    loc = p.local_idx.numpy() if loc is None else loc
    e = p.sorted_entries.numpy().astype(np.float32)
    slabs, scheds, copies = [], set(), {"16": 0, "4": 0, "zero": 0}
    for g in range(p.n_chunks):
        start = g * p.chunk
        s, sn, sched, cp = run_given_block(
            loc, e, sl, sr, start, min(start + p.chunk, nnz), p.span, nnz,
            gv, n_blocks or p.n_chunks, R_hashed=R_hashed, bases=bases)
        assert sn.max() <= 1  # every element stored once at most
        assert (s[sn == 0] == 0).all()  # the rest keep the zero pass's 0
        assert np.isfinite(s).all()
        slabs.append(s)
        scheds.add(sched)
        for k, v in cp.items():
            copies[k] += v
    return np.stack(slabs), scheds, copies


def _rows(r, nnz, seed):
    return np.random.default_rng(seed).standard_normal((r, nnz)).astype(
        np.float32)


# nnz % 4 sets which rows start 16-byte aligned; chunk 101 leaves e and
# loc unaligned from the second chunk on
GIVEN_NNZ = {"nnz % 4 = 0": (1500, None), "nnz % 4 = 1": (1501, None),
             "nnz % 4 = 2": (1502, None), "nnz % 4 = 3": (1503, None),
             "chunk 101": (1500, 101)}
#: the schedule as for these many blocks on the card, and the ring depth
#: given rows then take: one block (three stages at the widest stride),
#: MIN_BLOCKS_GIVEN an SM (two stages)
RING_BLOCKS = {"one block": (1, 3),
               "full card": (MIN_BLOCKS_GIVEN * N_SM, 2)}


@pytest.mark.parametrize("blocks", RING_BLOCKS, ids=list(RING_BLOCKS))
@pytest.mark.parametrize("case", GIVEN_NNZ, ids=list(GIVEN_NNZ))
def test_given_schedule_stores_once_and_sums(pallas_interpret, case,
                                             blocks):
    import jax.numpy as jnp
    from tt_sketch_tpu.kernels.pallas_psi import psi_chunk_slabs as j_slabs

    nnz, chunk = GIVEN_NNZ[case]
    jp, p = _given_plan(nnz, chunk)
    sl, sr = _rows(7, nnz, 1), _rows(13, nnz, 2)
    n_blocks, depth = RING_BLOCKS[blocks]
    got, scheds, copies = run_given(p, sl, sr, n_blocks)
    assert {s[3] for s in scheds} == {depth}
    ref = SP.psi_chunk_slabs_reference(
        p.local_idx, p.sorted_entries, torch.from_numpy(sl),
        torch.from_numpy(sr), p.n_chunks, p.span, p.chunk)
    assert _rel(got, ref.numpy()) <= PSI_TOL
    nc, S, C = jp.n_chunks, jp.span, jp.chunk
    pad = ((0, 0), (0, nc * C - nnz))
    jref = j_slabs(jp.local_idx, jnp.pad(jp.sorted_entries, pad[1]),
                   jnp.pad(jnp.asarray(sl), pad),
                   jnp.pad(jnp.asarray(sr), pad), n_chunks=nc, span=S,
                   chunk=C, interpret=True)
    assert _rel(got, np.asarray(jref).reshape(nc, S, 7, 13)) <= PSI_TOL
    # which rows took 16-byte copies: all where nnz % 4 == 0 and the chunk
    # keeps e and loc aligned; else some rows one value a copy
    aligned = nnz % 4 == 0 and (chunk or p.chunk) % 4 == 0
    assert copies["16"] > 0
    assert (copies["4"] == 0) == aligned


GIVEN_SIDES = {
    "7 x none": (7, None),
    "none x 13": (None, 13),
    "1 x 13": (1, 13),
    "1 x none": (1, None),
    "10 x 3 (A the left side)": (10, 3),
    "5 x 4": (5, 4),
    "16 x 40 (one group)": (16, 40),
    "30 x 40 (passes)": (30, 40),
}


@pytest.mark.parametrize("sides", GIVEN_SIDES, ids=list(GIVEN_SIDES))
def test_given_schedule_side_combinations(sides):
    r1, r2 = GIVEN_SIDES[sides]
    nnz = 1203
    _, p = _given_plan(nnz, 128)
    sl = None if r1 is None else _rows(r1, nnz, 3)
    sr = None if r2 is None else _rows(r2, nnz, 4)
    got, scheds, _ = run_given(p, sl, sr, gv=GV_RIGHT if sr is not None
                               else GV_LEFT)
    ref = SP.psi_chunk_slabs_reference(
        p.local_idx, p.sorted_entries,
        None if sl is None else torch.from_numpy(sl),
        None if sr is None else torch.from_numpy(sr), p.n_chunks, p.span,
        p.chunk)
    assert got.shape == tuple(ref.shape)
    assert _rel(got, ref.numpy()) <= PSI_TOL
    (_, G, _, _), = scheds
    if sides.startswith("30 x 40"):
        assert G == 1  # 300 micro-tiles: two passes of one group


def test_given_schedule_sentinel_tiles_and_a_one_row_chunk():
    nnz = 1501
    _, p = _given_plan(nnz, 256)
    loc = p.local_idx.numpy().copy()
    loc[96:256] = p.span  # chunk 0 ends in whole tiles of sentinels
    loc[p.chunk:2 * p.chunk] = 3  # every nonzero of chunk 1 on one row
    sl, sr = _rows(7, nnz, 5), _rows(13, nnz, 6)
    got, _, _ = run_given(p, sl, sr, loc=loc)
    ref = SP.psi_chunk_slabs_reference(
        torch.from_numpy(loc), p.sorted_entries, torch.from_numpy(sl),
        torch.from_numpy(sr), p.n_chunks, p.span, p.chunk)
    assert _rel(got, ref.numpy()) <= PSI_TOL
    every = np.full_like(loc, p.span)
    zero, _, _ = run_given(p, sl, sr, loc=every)
    assert (zero == 0).all()


@pytest.mark.parametrize("bases", [(1, 2, 3, 1), (2, 0, 1, 3)],
                         ids=["bases 1 2 3 1", "bases 2 0 1 3"])
def test_given_schedule_unaligned_tensors(bases):
    """Operands whose first element is not 16-byte aligned (a view with an
    offset) take 4-byte copies where their quads are unaligned."""
    nnz = 1500
    _, p = _given_plan(nnz, None)
    sl, sr = _rows(7, nnz, 7), _rows(13, nnz, 8)
    got, _, copies = run_given(p, sl, sr, bases=bases)
    ref = SP.psi_chunk_slabs_reference(
        p.local_idx, p.sorted_entries, torch.from_numpy(sl),
        torch.from_numpy(sr), p.n_chunks, p.span, p.chunk)
    assert _rel(got, ref.numpy()) <= PSI_TOL
    assert copies["4"] > 0


GENRIGHT = {
    "gauss 13": (7, ("g",), 13),
    "sign 13": (7, ("s", 13, 5, 0, 13), 5),
    "sign slice 5 of 9": (7, ("s", 9, 4, 3, 5), 4),
    "none x gauss 13": (None, ("g",), 13),
    "1 x gauss 1": (1, ("g",), 1),
}


@pytest.mark.parametrize("blocks", RING_BLOCKS, ids=list(RING_BLOCKS))
@pytest.mark.parametrize("case", GENRIGHT, ids=list(GENRIGHT))
def test_given_schedule_genright(pallas_interpret, case, blocks):
    """A given left side staged by the ring, the right side hashed into its
    tile (Gaussian, sign, sliced sign): against the plain version and, with
    a left side, the Pallas kernel in interpret mode."""
    import jax.numpy as jnp
    from tt_sketch_tpu.kernels.pallas_psi import (
        psi_chunk_slabs_genright as j_genright,
    )
    from tt_sketch_tpu.kernels import pallas_rng as JR

    r1, spec, n_salts = GENRIGHT[case]
    nnz = 1502
    jp, p = _given_plan(nnz, None)
    salts = drm_salts(0, n_salts, 9)
    R = SP._rows(p.flat_right, salts, spec, nnz, p.sorted_entries).numpy()
    sl = None if r1 is None else _rows(r1, nnz, 10)
    got, scheds, _ = run_given(p, sl, None, RING_BLOCKS[blocks][0], GV_LEFT,
                               R_hashed=R)
    assert {s[3] for s in scheds} == {1}  # the hashing hides the copies
    ref = SP.psi_chunk_slabs_genright_reference(
        p.local_idx, p.sorted_entries,
        None if sl is None else torch.from_numpy(sl), p.flat_right, salts,
        p.n_chunks, p.span, p.chunk, spec)
    assert _rel(got, ref.numpy()) <= PSI_TOL
    if sl is None:
        return
    nc, S, C = jp.n_chunks, jp.span, jp.chunk
    r2 = R.shape[0]
    jref = j_genright(jp.local_idx, jp.sorted_entries,
                      jnp.pad(jnp.asarray(sl), ((0, 0), (0, nc * C - nnz))),
                      jp.flat_right, JR.drm_salts(0, n_salts, 9),
                      n_chunks=nc, span=S, chunk=C, interpret=True,
                      rspec=spec)
    jref = np.asarray(jref)[:, :, :r2].reshape(nc, S, r1, r2)
    assert _rel(got, jref) <= PSI_TOL


#: (ranks, chunks, the card's schedule) of the recorded calls: given left
#: rows, right rows (None: no right side), hashed right rows (0: the right
#: side given); (TS, G, TG, NS, shared bytes) as ``tt_psi_given_schedule``
#: printed them on an NVIDIA H100 80GB HBM3 (``tools/sparse_psi_ab.py
#: given``), the 892 + 1 rows from this emulation
RECORDED_GIVEN = {
    "uber psi_chunk_slabs 10 x none": ((10, None, 0), 809,
                                       (252, 15, 16, 3, 43152)),
    "uber TT 10 x 10": ((10, 10, 0), 809, (252, 8, 28, 2, 53760)),
    "uber HMT genright 10 x gauss 10": ((10, 10, 10), 809,
                                        (252, 8, 28, 1, 31664)),
    "uber OTTS genright 10 x gauss 20": ((10, 20, 20), 809,
                                         (252, 5, 48, 1, 42600)),
    "nips 17 x none": ((17, None, 0), 756, (252, 15, 16, 2, 45588)),
    "small 7 x 13": ((7, 13, 0), 41, (252, 9, 28, 3, None)),
    "892 + 1 given rows": ((892, 1, 0), 41, (60, 1, 60, 1, None)),
}


@pytest.mark.parametrize("case", RECORDED_GIVEN, ids=list(RECORDED_GIVEN))
def test_given_schedule_at_the_recorded_calls(case):
    """The stride, groups, tile, ring depth and shared memory the recorded
    calls get on an H100 (MIN_BLOCKS_GIVEN blocks an SM, the registers'
    limit; a hashed right side in one stage), the 892 + 1 rows of the
    wrappers' limit in one stage of the narrowest stride."""
    (r1, r2, hashed), blocks, expect = RECORDED_GIVEN[case]
    has_r = r2 is not None
    r2 = r2 or 1
    gv = GV_LEFT if hashed or not has_r else GV_RIGHT
    ts, G, tg, ns, _, _, _, _, nst = given_schedule(
        r1, r2, True, has_r, gv, blocks, rows_r=hashed, salts_r=hashed)
    nbytes = given_layout_bytes(ts, G, ns, r1, r2, nst, hashed, hashed)
    assert (ts, G, tg, ns) == expect[:4]
    assert nbytes == (expect[4] or nbytes) and nbytes <= SMEM_LIMIT


#: given-rows calls at the wrappers' limit: (given left rows, right rows,
#: a hashed right side's rows allocated and salts, instance)
GIVEN_LIMIT_CASES = {
    "given 892 + 1": (892, 1, 0, 0, GV_RIGHT),
    "given 892, no right side": (892, 1, 0, 0, GV_LEFT),
    "given 891 + gauss 1": (891, 1, 1, 1, GV_LEFT),
    "given 1 + sign 865 of 865": (1, 865, 865, 865, GV_LEFT),
    "given 100 + gauss 700": (100, 700, 700, 700, GV_LEFT),
    "given 446 + 446": (446, 446, 0, 0, GV_RIGHT),
}


@pytest.mark.parametrize("case", GIVEN_LIMIT_CASES,
                         ids=list(GIVEN_LIMIT_CASES))
def test_given_layout_fits_the_wrappers_limit(case):
    """Every given-rows call the wrappers admit (``_check_shared_memory``:
    260 bytes a row, 8 a salt) fits the given-rows layout: at worst one
    stage of the narrowest stride."""
    r1, r2, rows_r, salts, gv = GIVEN_LIMIT_CASES[case]
    has_r = "no right" not in case
    rows = r1 + (r2 if has_r else 0)
    api = 8 * salts + 4 * (64 + 1) * rows + 4 * 64
    assert api <= SMEM_LIMIT  # what the wrappers admit
    ts, G, _, ns, _, _, _, _, nst = given_schedule(
        r1, r2, True, has_r, gv, 1, rows_r=rows_r, salts_r=salts)
    assert given_layout_bytes(ts, G, ns, r1, r2, nst, rows_r,
                              salts) <= SMEM_LIMIT
    one_more = 8 * salts + 4 * (64 + 1) * (rows + 1) + 4 * 64
    if case == "given 892 + 1":
        assert one_more > SMEM_LIMIT and (ts, ns) == (STRIDES[-1], 1)


# -- 5. the one-sided instances, emulated ------------------------------------------

ONE_WARPS, ONE_WARPS_MAX, ONE_STAGE, ONE_MAX_ROWS = (
    _const(n) for n in ("ONE_WARPS", "ONE_WARPS_MAX", "ONE_STAGE",
                        "ONE_MAX_ROWS"))
LANES = 32


def one_bucket(has_l, has_r, r, spec):
    """``one_bucket`` of the kernel source: the rows bucket of a one-sided
    call's instance, 0 where the tiled block program serves the call."""
    if has_l == has_r:
        return 0
    sign = tuple(spec)[0] == "s"
    rows = spec[1] if sign else r
    if r <= 0 or rows > ONE_MAX_ROWS:
        return 0
    if sign:
        return 16 if rows <= 16 else 32
    return next(b for b in (8, 16, 24, 32) if rows <= b)


class OneStage:
    """A warp's output stage: ONE_STAGE rows from ``b0`` of the rows ``[..,
    hi)`` it owns, open for adds until a row past them comes, then flushed
    to ``out`` (counting every element stored)."""

    def __init__(self, out, count, b0, hi, r):
        self.out, self.count, self.b0, self.hi, self.r = out, count, b0, hi, r
        self.buf = np.zeros((ONE_STAGE, r), np.float32)

    def flush(self):
        n = min(self.b0 + ONE_STAGE, self.hi) - self.b0
        if n > 0:
            self.out[self.b0:self.b0 + n] = self.buf[:n]
            self.count[self.b0:self.b0 + n] += 1
        self.buf[:] = 0
        self.b0 += ONE_STAGE

    def add(self, row, vals):
        assert self.b0 <= row < self.hi  # rows come in increasing order
        while row >= self.b0 + ONE_STAGE:
            self.flush()
        self.buf[row - self.b0] += vals

    def finish(self):
        while self.b0 < self.hi:
            self.flush()


def _lanes_sum(acc):
    """``lanes_sum``: lane 0's sums by the xor butterfly over the lanes."""
    x = acc.copy()
    for o in (16, 8, 4, 2, 1):
        x = (x + x[np.arange(LANES) ^ o]).astype(np.float32)
    return x[0]


def one_part(loc, P, lo, hi, h_row, t_row, span, win, stage, slots, steps):
    """One warp over the columns ``[lo, hi)`` as ``one_part`` of the kernel
    source: ``P`` (N, r) the products e·row of every column (a pad's are
    0); a row's sums are added to ``slots`` (head, tail) for rows ``h_row``
    and ``t_row`` of a fused part, else to the stage; ``steps`` counts the
    steps that continue the open run and the others."""
    r = P.shape[1]
    lanes = np.arange(LANES)
    acc = np.zeros((LANES, r), np.float32)
    s_cur, spread = int(loc[lo]), False

    def add(row, vals):
        if row == h_row:
            slots[0][1] += vals
        elif row == t_row:
            slots[1][1] += vals
        else:
            stage.add(row, vals)

    for k0 in range(lo, hi, LANES):
        k = k0 + lanes
        inn = k < hi
        kc = np.minimum(k, hi - 1)
        lc = np.where(inn, loc[kc], span if win else t_row)
        f, l = int(lc[0]), int(lc[-1])
        if win and f >= span:
            break  # the rest are pads
        p = np.where(inn[:, None], P[kc], 0).astype(np.float32)
        cont = f == l == s_cur
        steps["continue" if cont else "runs"] += 1
        if not cont and spread:
            add(s_cur, _lanes_sum(acc))
            spread = False
        if cont:
            acc = (acc + p).astype(np.float32)
            spread = True
            continue
        x = p
        first = np.r_[True, lc[1:] != lc[:-1]]
        starts = np.r_[np.flatnonzero(first), LANES]
        longest = int(np.diff(starts).max())
        o = 1
        while o < longest:  # a run's sum onto its first lane
            nb = np.minimum(lanes + o, LANES - 1)
            same = (lanes + o < LANES) & (lc[nb] == lc)
            x = np.where(same[:, None], x + x[nb], x).astype(np.float32)
            o *= 2
        for i in np.flatnonzero(first):
            if not (win and lc[i] >= span):
                add(int(lc[i]), x[i])
        acc = np.zeros((LANES, r), np.float32)
        s_cur = l
    if spread and not (win and s_cur >= span):
        add(s_cur, _lanes_sum(acc))
    stage.finish()


def one_fused(loc, P, nnz, n_chunks, span, chunk, warps=ONE_WARPS):
    """Every block of the fused one-sided instance, of ``warps`` warps
    (ONE_WARPS_MAX where the grid fits the card at once): ``(slabs
    (n_chunks, span, r), stores per element, steps)``."""
    r = P.shape[1]
    slabs = np.full((n_chunks, span, r), np.nan, np.float32)
    count = np.zeros((n_chunks, span, r), np.int64)
    steps = {"continue": 0, "runs": 0}
    for g in range(n_chunks):
        start, end = g * chunk, min(g * chunk + chunk, nnz)
        n = max(end - start, 0)
        q = -(-(-(-n // warps)) // LANES) * LANES
        slots = []
        for w in range(warps):
            lo, hi = start + w * q, min(start + w * q + q, end)
            s = [None, None]
            if lo < hi:
                h_row, t_row = int(loc[lo]), int(loc[hi - 1])
                s = [[h_row, np.zeros(r, np.float32)],
                     [t_row, np.zeros(r, np.float32)] if t_row != h_row
                     else None]
                st = OneStage(slabs[g], count[g], h_row + 1, t_row, r)
                one_part(loc, P, lo, hi, h_row, t_row, span, False, st, s,
                         steps)
            slots.append(s)
        _one_combine(slots, slabs[g], count[g], span)
    return slabs, count, steps


def _one_combine(slots, slab, count, span):
    """Warp 0 after the barrier: heads and tails in warp order, each of
    their rows stored once, zeros on the rows no warp's stage owns."""
    entries = [(s[u][0], s[u][1], u == 0 and s[1] is not None)
               for s in slots for u in (0, 1) if s[u] is not None]
    cur, total, owned, done = -1, None, False, 0

    def zero_to(row):
        slab[done:row] = 0
        count[done:row] += 1

    for row, v, head_with_tail in entries:
        if row == cur:
            total = (total + v).astype(np.float32)
        else:
            if cur >= 0:
                slab[cur] = total
                count[cur] += 1
                done = cur + 1
            if not owned:
                zero_to(row)
            cur, total = row, v.copy()
        owned = head_with_tail
        if not owned:
            done = row + 1
    if cur >= 0:
        slab[cur] = total
        count[cur] += 1
    done = cur + 1
    zero_to(span)


def one_window(win, loc, P, n_chunks, span, chunk, n_windows, fit):
    """Every block of the window one-sided instance, ``fit`` blocks on the
    card at once: ``(psi (n_windows·span, r), stores per element, steps,
    windows a block)``."""
    r = P.shape[1]
    psi = np.full((n_windows * span, r), np.nan, np.float32)
    count = np.zeros((n_windows * span, r), np.int64)
    steps = {"continue": 0, "runs": 0}
    blocks = min(-(-n_windows // ONE_WARPS), fit)
    per = -(-n_windows // blocks)
    blocks = -(-n_windows // per)
    for b in range(blocks):
        w1 = min(b * per + per, n_windows)
        for warp in range(ONE_WARPS):
            for w in range(b * per + warp, w1, ONE_WARPS):
                c_lo = int(np.searchsorted(win, w, "left"))
                c_hi = int(np.searchsorted(win, w, "right"))
                rows = slice(w * span, (w + 1) * span)
                st = OneStage(psi[rows], count[rows], 0, span, r)
                lo, hi = c_lo * chunk, c_hi * chunk
                if lo < hi:
                    one_part(loc, P, lo, hi, -1, -1, span, True, st, None,
                             steps)
                else:
                    st.finish()
    return psi, count, steps, per


def _one_side(kind, r, seed, flat, n, ent, weight):
    """(spec, salts, products (n, r)) of a present side: Gaussian rows, or
    sign rows of rank ``r`` (r_out ``r``) from min(r, 5) draws."""
    if kind == "g":
        spec, salts = GAUSS, drm_salts(0, r, seed)
    else:
        spec, salts = ("s", r, min(r, 5), 0, r), drm_salts(0, min(r, 5), seed)
    rows = SP._rows(flat, salts, spec, n, ent, ent).numpy()
    return spec, salts, np.ascontiguousarray(rows.T)


ONE_FUSED = {
    "left gauss 10": ("left", "g", 10, None),
    "right gauss 10": ("right", "g", 10, None),
    "left sign 10": ("left", "s", 10, None),
    "right sign 16": ("right", "s", 16, None),
    "left gauss 1": ("left", "g", 1, None),
    "right gauss 31, chunk 100": ("right", "g", 31, 100),
    "left sign 32": ("left", "s", 32, None),
    "right sign 1": ("right", "s", 1, None),
    "left gauss 32, chunk 33": ("left", "g", 32, 33),
    "right gauss 10, one-column chunks": ("right", "g", 10, 1),
}


@pytest.mark.parametrize("warps", [ONE_WARPS, ONE_WARPS_MAX],
                         ids=lambda w: f"{w} warps")
@pytest.mark.parametrize("case", ONE_FUSED, ids=list(ONE_FUSED))
def test_oneside_fused_schedule_stores_once_and_sums(case, warps):
    """The fused one-sided instance: each slab element stored once (zeros
    included), the sums against the plain version; runs that cross lanes,
    warps and steps, and steps that continue a run."""
    side, kind, r, chunk = ONE_FUSED[case]
    plans, nnz = _plans(threshold=8, chunk=chunk)
    plan = plans[3 if side == "left" else 0]
    assert isinstance(plan, ModePlan)
    ent = plan.sorted_entries
    flat = plan.flat_left if side == "left" else plan.flat_right
    spec, salts, P = _one_side(kind, r, 5, flat, nnz, ent, ent)
    assert one_bucket(side == "left", side == "right", r, spec) > 0
    loc = plan.local_idx.numpy()
    got, count, steps = one_fused(loc, P, nnz, plan.n_chunks, plan.span,
                                  plan.chunk, warps)
    assert (count == 1).all()
    args = (None, flat, None, salts) if side == "right" else \
        (flat, None, salts, None)
    ref = SP.psi_fused_slabs_reference(
        plan.local_idx, ent, *args, plan.n_chunks, plan.span, plan.chunk,
        *((GAUSS, spec) if side == "right" else (spec, GAUSS)))
    assert _rel(got, ref.numpy().reshape(got.shape)) <= PSI_TOL
    if chunk is None:
        assert steps["continue"] > 0 and steps["runs"] > 0


def _skewed_window_plan(span=32, chunk=64, nnz=3001, seed=31):
    """A window plan of a skewed mode (3000 rows): a hot window of several
    chunks (rows of long runs), hot rows spread over windows of one or two
    chunks (runs of one or two nnz), a gap of empty windows; the JAX
    package's plan and the port's copy of it."""
    from tt_sketch_tpu.kernels.sparse_plan import build_window_plan as j_win

    from tt_sketch_torch.kernels.sparse_plan import build_window_plan

    shape, mu = (11, 9, 3000, 25), 2
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape]).astype(np.int64)
    u = rng.random(nnz)
    idx[mu] = np.where(u < 0.25, rng.integers(0, 4, nnz),  # 4 hot rows
                       np.where(u < 0.6, rng.integers(100, 500, nnz),
                                rng.integers(2400, 3000, nnz)))
    ent = rng.standard_normal(nnz).astype(np.float32)
    kw = dict(span=span, chunk=chunk, full_indices=idx, mu=mu, shape=shape,
              entries=ent)
    return (build_window_plan(idx[mu], shape[mu], device="cpu", **kw),
            j_win(idx[mu], shape[mu], **kw))


ONE_WINDOW = {
    "left gauss 10": ("left", "g", 10, 1 << 20),
    "right gauss 10": ("right", "g", 10, 1 << 20),
    "left sign 10": ("left", "s", 10, 1 << 20),
    "right sign 32": ("right", "s", 32, 1 << 20),
    "left gauss 1, three windows a block": ("left", "g", 1, 8),
    "right gauss 31, eleven windows a block": ("right", "g", 31, 3),
    "left gauss 32": ("left", "g", 32, 1 << 20),
    "left sign 31": ("left", "s", 31, 1 << 20),
}


@pytest.mark.parametrize("case", ONE_WINDOW, ids=list(ONE_WINDOW))
def test_oneside_window_schedule_stores_once_and_sums(case):
    """The window one-sided instance: a warp owns whole windows (empty ones,
    windows of one to several chunks, runs crossing lanes, steps and chunk
    boundaries, a window's last step ending in pads), every row of every
    window stored once, the sums against the plain version."""
    side, kind, r, fit = ONE_WINDOW[case]
    p, _ = _skewed_window_plan()
    n_pad = p.n_chunks * p.chunk
    ent = p.sorted_entries
    flat = p.flat_left if side == "left" else p.flat_right
    spec, salts, P = _one_side(kind, r, 7, flat, n_pad, ent, ent)
    assert one_bucket(side == "left", side == "right", r, spec) > 0
    win, loc = p.chunk_window.numpy(), p.local_idx.numpy()
    per_window = np.bincount(win, minlength=p.n_windows)
    assert per_window.max() >= 3 and (per_window == 1).any()
    real = (loc.reshape(p.n_chunks, -1) < p.span).any(1)
    empty = np.setdiff1d(np.arange(p.n_windows), win[real])
    assert empty.size > 0  # windows of pads alone
    got, count, steps, per = one_window(win, loc, P, p.n_chunks, p.span,
                                        p.chunk, p.n_windows, fit)
    assert (count == 1).all()
    assert steps["continue"] > 0 and steps["runs"] > 0
    if fit < 16:
        assert per > ONE_WARPS  # a warp takes several windows in turn
    args = (None, flat, None, salts) if side == "right" else \
        (flat, None, salts, None)
    ref = SP.psi_window_direct_reference(
        p.chunk_window, p.chunk_first, p.local_idx, ent, *args, p.n_chunks,
        p.span, p.chunk, p.n_windows,
        *((GAUSS, spec) if side == "right" else (spec, GAUSS)))
    assert _rel(got, ref.numpy().reshape(got.shape)) <= PSI_TOL
    assert not got.reshape(p.n_windows, p.span, r)[empty].any()


def _jax_salts(spec, n_salts, seed):
    """The JAX kernels' salts of a side: a sign side's padded to its
    working range of rows (multiples of 8)."""
    from tt_sketch_tpu.kernels import pallas_rng as JR

    if tuple(spec) == GAUSS:
        return JR.drm_salts(0, n_salts, seed)
    _, rank, _, rank_min, r_out = spec
    r_full = -(-max(rank, rank_min + -(-max(r_out, 1) // 8) * 8) // 8) * 8
    return JR.drm_salts(0, r_full, seed)


ONE_PALLAS = {
    "fused, no right side, gauss 10": ("fused", "left", "g", 10),
    "fused, no left side, sign 13": ("fused", "right", "s", 13),
    "window, no right side, sign 10": ("window", "left", "s", 10),
    "window, no left side, gauss 7": ("window", "right", "g", 7),
}


@pytest.mark.parametrize("case", ONE_PALLAS, ids=list(ONE_PALLAS))
def test_oneside_schedule_matches_pallas(pallas_interpret, case):
    """The one-sided emulation against the Pallas kernels in interpret mode
    (``_fused_kernel_noright``, ``_fused_kernel_noleft``,
    ``_window_kernel_oneside``) on the JAX package's plans."""
    from tt_sketch_tpu.kernels import pallas_psi as JP

    kernel, side, kind, r = ONE_PALLAS[case]
    left = side == "left"
    if kernel == "fused":
        jp, p = _given_plan(1500, 256, mu=3 if left else 0)
        n_pad = p.sorted_entries.shape[0]
    else:
        p, jp = _skewed_window_plan(span=24, chunk=96, nnz=2000, seed=5)
        n_pad = p.n_chunks * p.chunk
    ent = p.sorted_entries
    flat = p.flat_left if left else p.flat_right
    spec, salts, P = _one_side(kind, r, 3, flat, n_pad, ent, ent)
    jsalts = _jax_salts(spec, salts.shape[0], 3)
    jflats = (jp.flat_left, None) if left else (None, jp.flat_right)
    jside = dict(lspec=spec, rspec=GAUSS) if left else \
        dict(lspec=GAUSS, rspec=spec)
    loc = p.local_idx.numpy()
    if kernel == "fused":
        got, count, _ = one_fused(loc, P, n_pad, p.n_chunks, p.span,
                                  p.chunk)
        ref = JP.psi_fused_slabs(
            jp.local_idx, jp.sorted_entries, *jflats,
            *((jsalts, None) if left else (None, jsalts)),
            n_chunks=jp.n_chunks, span=jp.span, chunk=jp.chunk,
            interpret=True, **jside)
    else:
        got, count, _, _ = one_window(p.chunk_window.numpy(), loc, P,
                                      p.n_chunks, p.span, p.chunk,
                                      p.n_windows, 1 << 20)
        ref = JP.psi_window_direct(
            jp.chunk_window, jp.chunk_first, jp.local_idx, jp.sorted_entries,
            *jflats, *((jsalts, None) if left else (None, jsalts)),
            n_chunks=jp.n_chunks, span=jp.span, chunk=jp.chunk,
            n_windows=jp.n_windows, interpret=True, **jside)
    assert (count == 1).all()
    ref = np.asarray(ref)[:, :, :r].reshape(got.shape)
    assert _rel(got, ref) <= PSI_TOL


@pytest.mark.parametrize("sides,r,spec,bucket", [
    ((True, False), 10, GAUSS, 16), ((False, True), 8, GAUSS, 8),
    ((True, False), 32, GAUSS, 32), ((False, True), 1, GAUSS, 8),
    ((False, True), 20, GAUSS, 24), ((True, False), 17, GAUSS, 24),
    ((True, False), 5, ("s", 32, 7, 20, 5), 32),
    ((False, True), 9, ("s", 16, 16, 0, 9), 16),
    ((True, False), 33, GAUSS, 0), ((False, True), 3, ("s", 33, 5, 0, 3), 0),
    ((True, True), 10, GAUSS, 0)],
    ids=["left 10", "right 8", "left 32", "right 1", "right 20", "left 17",
         "sign 5 of 32",
         "sign 9 of 16", "rank 33: tiled", "sign rank 33: tiled",
         "two-sided: tiled"])
def test_oneside_dispatch_by_shape(sides, r, spec, bucket):
    """Which calls take the one-sided instances (the bucket of their rows),
    and which the tiled block program: a side of more than ONE_MAX_ROWS rows
    (a sign side: of rank), and every two-sided call."""
    assert one_bucket(*sides, r, spec) == bucket
    assert ONE_MAX_ROWS == 32
