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
