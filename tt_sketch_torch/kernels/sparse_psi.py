"""Fused sparse Ψ/Ω contractions with the DRM rows hashed inside the kernel.

Counterpart of ``tt_sketch_tpu/kernels/pallas_psi.py``:
``psi_fused_slabs``, ``omega_fused``, ``psi_omega_merged_slabs``,
``psi_window_direct`` and, for rows that are given and not hashed,
``psi_chunk_slabs`` and ``psi_chunk_slabs_genright``.  On CUDA tensors each
launches its hand-written kernel of ``tt_sketch_torch/csrc/sparse_psi.cu``
(built at first use, see ``cuda_build``) or raises; on CPU tensors it
computes its plain version (``*_reference``).  There is no fallback from
one to the other.

A side is described by its int64 flat indices (the plan's ``flat_left``
etc.), its int64 column salts and a spec, as in the JAX package:

- ``("g",)``: lazy-Gaussian rows, one per salt (``hash_rng.drm_salts`` of
  the DRM's rank slice);
- ``("s", rank, nnz, rank_min, r_out)``: sparse-sign rows
  ``[rank_min, rank_min + r_out)`` of the shuffle over ``rank`` slots; the
  salts are those of columns ``[0, nnz)`` (not padded to the TPU's
  multiple of 8 rows).

A call with one side missing and the other hashed, of at most 32 rows (a
sign side: of rank at most 32), takes instances of the kernel of their own
(``oneside_schedule``): a lane hashes a column's rows into registers and
the warp sums runs of equal ``loc`` over its lanes, with no tile in shared
memory; every other call takes the tiled block program.

``psi_chunk_slabs`` and ``psi_chunk_slabs_genright`` take a side's rows as a
float32 ``(r, nnz)`` tensor in the plan's sorted order (a sequential
sketch's chain state, a TT-DRM's rows): instances of the kernel of their
own stage them in shared memory by asynchronous copies, a few tiles ahead
of the contraction (a row whose start is not 16-byte aligned, as when
``nnz % 4 != 0``, one value a copy).

The two sides of a call may differ (mixed pairs).  Layouts are the port's
own: slabs are ``(n_chunks, span, r1, r2)`` float32 with ``r1 = 1`` without
a left side and ``r2 = 1`` without a right side, the window kernel's Ψ is
``(n_windows·span, r1, r2)``, and ranks are not padded (the TPU kernels pad
them to multiples of 8).

Rank limit of the kernels: a block keeps every side's rows for a tile of
nnz in shared memory, and a sign side keeps all ``rank`` slots of its
shuffle there whatever its ``r_out``.  The limit is counted as 260 bytes
per row (a 64-nnz tile) plus 8 bytes per salt within 232,192 bytes: 866
rows in all with a salt each (two sign sides of rank 433 with ``nnz =
rank``, or three of rank 288 in the merged kernel).  A given side keeps its
``r`` rows there and no salts (893 rows when nothing else is held).  Beyond
that the wrappers raise ``ValueError`` before the launch
(``sparse_sign_rows`` alone takes ranks up to 5811).  Every call inside the
limit fits the kernel's narrowest layout (60-nnz tiles, 240 bytes per row,
plus the threads' parked sums); the kernel takes a wider tile where the
call's layout fits it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.kernels import cuda_build
from tt_sketch_torch.kernels.cuda_build import I32, I64, PTR, check_int64
from tt_sketch_torch.kernels.lazy_gaussian import lazy_gaussian_reference
from tt_sketch_torch.kernels.sparse_sign import (
    check_slice,
    sparse_sign_rows_reference,
)

_GAUSS = ("g",)
#: a side whose rows are given as an (r, nnz) tensor in place of ``flat``
_GIVEN = ("a",)

#: nnz per step of the plain versions (bounds their temporaries)
_REF_BLOCK = 1 << 18

#: opt-in shared memory per block, and the tile width the rank limit is
#: counted in (csrc/sparse_psi.cu fits every call inside it)
_SMEM_LIMIT, _TILE = 232448, 64


def _side_rows(spec, flat, salts) -> int:
    """Rows a side contributes (1 for a missing side); checks the spec
    against its salts."""
    if flat is None:
        return 1
    spec = tuple(spec)
    if spec == _GIVEN:
        return flat.shape[0]
    if spec == _GAUSS:
        return salts.shape[0]
    if len(spec) == 5 and spec[0] == "s":
        _, rank, nnz, rank_min, r_out = spec
        check_slice(salts, rank, nnz, rank_min, rank_min + r_out)
        return r_out
    raise ValueError(f"side spec {spec!r}: expected ('g',) or "
                     f"('s', rank, nnz, rank_min, r_out)")


def _cols(x, sl):
    """Columns ``sl`` of a side: of its flat stream, or of its given rows."""
    if x is None:
        return None
    return x[sl] if x.ndim == 1 else x[:, sl]


def _rows(flat, salts, spec, n, like, weight=None):
    """(r, n) rows of one side, or a row of ones for a missing side; the
    entries ``weight`` scale them when given."""
    if flat is None:
        rows = torch.ones((1, n), dtype=torch.float32, device=like.device)
    elif tuple(spec) == _GIVEN:
        rows = flat.to(torch.float32)
    elif tuple(spec) == _GAUSS:
        rows = lazy_gaussian_reference(flat, salts)
    else:
        _, rank, nnz, rank_min, r_out = spec
        rows = sparse_sign_rows_reference(flat, salts, rank, nnz, rank_min,
                                          rank_min + r_out)
    return rows if weight is None else rows * weight


# -- plain versions ----------------------------------------------------------

def _psi_blocks_reference(loc, se, lflat, rflat, lsalts, rsalts, lspec,
                          rspec, block_of, n_blocks: int, span: int):
    """Σ over the stream of ``L[:,k]·e[k] ⊗ R[:,k]`` into row ``loc[k]`` of
    block ``block_of(k)``: hashed rows, outer products and an
    ``index_add_`` (the sentinel ``loc == span`` goes to a dump row per
    block that is dropped).  Returns (n_blocks, span, r1, r2)."""
    nnz = se.shape[0]
    r1 = _side_rows(lspec, lflat, lsalts)
    r2 = _side_rows(rspec, rflat, rsalts)
    out = torch.zeros((n_blocks * (span + 1), r1 * r2), dtype=torch.float32,
                      device=se.device)
    for k0 in range(0, nnz, _REF_BLOCK):
        sl = slice(k0, min(k0 + _REF_BLOCK, nnz))
        n = sl.stop - k0
        e = se[sl].to(torch.float32)
        L = _rows(_cols(lflat, sl), lsalts, lspec, n, e, e)
        R = _rows(_cols(rflat, sl), rsalts, rspec, n, e)
        outer = (L.T[:, :, None] * R.T[:, None, :]).reshape(n, r1 * r2)
        k = torch.arange(k0, sl.stop, device=se.device)
        row = block_of(k) * (span + 1) + loc[sl].to(torch.int64).clamp(
            0, span)
        out.index_add_(0, row, outer)
    return out.reshape(n_blocks, span + 1, r1, r2)[:, :span].contiguous()


def psi_fused_slabs_reference(loc, se, lflat, rflat, lsalts, rsalts,
                              n_chunks: int, span: int, chunk: int,
                              lspec=_GAUSS, rspec=_GAUSS) -> torch.Tensor:
    """Plain PyTorch version of ``psi_fused_slabs``."""
    return _psi_blocks_reference(loc, se, lflat, rflat, lsalts, rsalts,
                                 lspec, rspec, lambda k: k // chunk,
                                 n_chunks, span)


def psi_chunk_slabs_reference(loc, se, sl, sr, n_chunks: int, span: int,
                              chunk: int) -> torch.Tensor:
    """Plain PyTorch version of ``psi_chunk_slabs``."""
    return _psi_blocks_reference(loc, se, sl, sr, None, None, _GIVEN, _GIVEN,
                                 lambda k: k // chunk, n_chunks, span)


def psi_chunk_slabs_genright_reference(loc, se, sl, rflat, rsalts,
                                       n_chunks: int, span: int, chunk: int,
                                       rspec=_GAUSS) -> torch.Tensor:
    """Plain PyTorch version of ``psi_chunk_slabs_genright``."""
    return _psi_blocks_reference(loc, se, sl, rflat, None, rsalts, _GIVEN,
                                 rspec, lambda k: k // chunk, n_chunks, span)


def psi_window_direct_reference(win, first, loc, se, lflat, rflat, lsalts,
                                rsalts, n_chunks: int, span: int, chunk: int,
                                n_windows: int, lspec=_GAUSS,
                                rspec=_GAUSS) -> torch.Tensor:
    """Plain PyTorch version of ``psi_window_direct``: slot ``k`` of the
    padded stream adds into row ``loc[k]`` of window ``win[k // chunk]``
    (``first`` is what the TPU kernel initializes on; a sum needs it not)."""
    win64 = win.to(torch.int64)
    psi = _psi_blocks_reference(loc, se, lflat, rflat, lsalts, rsalts, lspec,
                                rspec, lambda k: win64[k // chunk],
                                n_windows, span)
    return psi.reshape(n_windows * span, psi.shape[2], psi.shape[3])


def omega_fused_reference(e, lflat, rflat, lsalts, rsalts, lspec=_GAUSS,
                          rspec=_GAUSS) -> torch.Tensor:
    """Plain PyTorch version of ``omega_fused``: ``(L·e) @ Rᵀ`` in nnz
    blocks, float32."""
    om = torch.zeros((_side_rows(lspec, lflat, lsalts),
                      _side_rows(rspec, rflat, rsalts)), dtype=torch.float32,
                     device=e.device)
    for k0 in range(0, e.shape[0], _REF_BLOCK):
        sl = slice(k0, k0 + _REF_BLOCK)
        ek = e[sl].to(torch.float32)
        n = ek.shape[0]
        L = _rows(lflat[sl], lsalts, lspec, n, ek, ek)
        om += L @ _rows(rflat[sl], rsalts, rspec, n, ek).T
    return om


def psi_omega_merged_slabs_reference(loc, se, lflat, rflat, oflat, lsalts,
                                     rsalts, osalts, n_chunks: int,
                                     span: int, chunk: int, lspec=_GAUSS,
                                     rspec=_GAUSS, ospec=_GAUSS):
    """Plain PyTorch version of ``psi_omega_merged_slabs``."""
    slabs = psi_fused_slabs_reference(loc, se, lflat, rflat, lsalts, rsalts,
                                      n_chunks, span, chunk, lspec, rspec)
    return slabs, omega_fused_reference(se, oflat, rflat, osalts, rsalts,
                                        ospec, rspec)


# -- kernels -----------------------------------------------------------------

@functools.cache
def _library():
    """The built kernel library with its C signatures declared (once per
    process)."""
    spec = ctypes.POINTER(ctypes.c_int)
    return cuda_build.library("sparse_psi", {
        "tt_psi_fused_slabs": (
            [PTR] * 7 + [I64] + [I32] * 5 + [spec] * 2 + [PTR], I32),
        "tt_psi_window_direct": (
            [PTR] * 9 + [I32] * 6 + [spec] * 2 + [PTR], I32),
        "tt_psi_chunk_slabs": (
            [PTR] * 7 + [I64] + [I32] * 5 + [spec] + [PTR], I32),
        "tt_omega_fused": (
            [PTR] * 6 + [I64, I32, I32] + [spec] * 2 + [PTR], I32),
        "tt_psi_omega_merged": (
            [PTR] * 10 + [I64] + [I32] * 6 + [spec] * 3 + [PTR], I32),
        "tt_psi_given_schedule": ([I32] * 6 + [spec] * 2, I32),
        "tt_psi_oneside_schedule": ([I32] * 5 + [spec] * 2 + [I32, spec],
                                    I32),
        "tt_omega_chunk": ([], I32),
    })


def _c_spec(spec):
    """The kernel library's ``int[4] {1, rank, nnz, rank_min}`` of a sign
    side; None (a null pointer) for a Gaussian one."""
    if tuple(spec) == _GAUSS:
        return None
    _, rank, nnz, rank_min, _ = spec
    return (ctypes.c_int * 4)(1, int(rank), int(nnz), int(rank_min))


def _check_shared_memory(name: str, *sides) -> None:
    """Raise if the rows and salts of ``sides`` (``(flat, spec, r)`` each)
    do not fit a block's shared memory (``Layout::bytes`` of the kernel
    source): a sign side allocates ``rank`` rows, any other its ``r``; a
    missing or given side has no salts."""
    rows = n_salts = 0
    for flat, spec, r in sides:
        sign = flat is not None and tuple(spec)[0] == "s"
        rows += spec[1] if sign else r
        if flat is not None and tuple(spec) != _GIVEN:
            n_salts += spec[2] if sign else r
    need = 8 * n_salts + 4 * (_TILE + 1) * rows + 4 * _TILE
    if need > _SMEM_LIMIT:
        raise ValueError(
            f"{name}: {rows} rows (a sign side counts its rank) and "
            f"{n_salts} salts need {need} bytes of shared memory per block, "
            f"the kernel has {_SMEM_LIMIT}: about "
            f"{(_SMEM_LIMIT - 4 * _TILE) // (4 * (_TILE + 1) + 8)} rows over "
            f"all sides")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _prepare(se, loc=None, **int64s):
    """Check the kernel operands; returns the entries as float32."""
    device = se.device
    if device.type != "cuda":
        raise ValueError(f"sparse_psi: no kernel for {device}")
    for name, t in int64s.items():
        if t is not None:
            check_int64(name, t, device)
    if loc is not None and (loc.device != device or loc.dtype != torch.int32
                            or not loc.is_contiguous()):
        raise ValueError("loc must be a contiguous int32 tensor on "
                         f"{device}, got {loc.dtype} on {loc.device}")
    if se.ndim != 1 or se.shape[0] == 0:
        raise ValueError(f"entries must be a non-empty 1-D tensor, got shape "
                         f"{tuple(se.shape)}")
    return se.to(torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_geometry(loc, se, n_chunks, span, chunk):
    if loc.shape[0] != n_chunks * chunk or se.shape[0] > n_chunks * chunk:
        raise ValueError(
            f"plan geometry n_chunks={n_chunks} x chunk={chunk} does not fit "
            f"loc of {loc.shape[0]} and {se.shape[0]} entries")


@profiling.spanned("tt.kernel.psi_fused_slabs")
def psi_fused_slabs(loc, se, lflat, rflat, lsalts, rsalts, n_chunks: int,
                    span: int, chunk: int, lspec=_GAUSS,
                    rspec=_GAUSS) -> torch.Tensor:
    """Per-chunk Ψ slabs ``(n_chunks, span, r1, r2)`` float32, DRM rows
    hashed at the plan's sorted order.

    ``loc`` (n_chunks·chunk,) int32 local rows (sentinel ``span``), ``se``
    (nnz,) sorted entries, ``lflat``/``rflat`` (nnz,) int64 flat indices
    (either may be None: boundary modes), ``lsalts``/``rsalts`` int64 column
    salts, ``lspec``/``rspec`` the sides' specs (module docstring).
    Counted as ``launches.psi_fused_slabs``."""
    if lflat is None and rflat is None:
        raise ValueError("psi_fused_slabs needs a left or a right side")
    r1 = _side_rows(lspec, lflat, lsalts)
    r2 = _side_rows(rspec, rflat, rsalts)
    if _on_cpu(loc, se, lflat, rflat, lsalts, rsalts):
        return psi_fused_slabs_reference(loc, se, lflat, rflat, lsalts,
                                         rsalts, n_chunks, span, chunk,
                                         lspec, rspec)
    e = _prepare(se, loc, lflat=lflat, rflat=rflat,
                 lsalts=lsalts if lflat is not None else None,
                 rsalts=rsalts if rflat is not None else None)
    _check_geometry(loc, e, n_chunks, span, chunk)
    _check_shared_memory("psi_fused_slabs", (lflat, lspec, r1),
                         (rflat, rspec, r2))
    lib = _library()
    slabs = torch.empty((n_chunks, span, r1, r2), dtype=torch.float32,
                        device=e.device)
    cuda_build.launch(
        lib, "tt_psi_fused_slabs", e.device, loc.data_ptr(), e.data_ptr(),
        _ptr(lflat), _ptr(rflat), _ptr(lsalts if lflat is not None else None),
        _ptr(rsalts if rflat is not None else None), slabs.data_ptr(),
        e.shape[0], n_chunks, span, chunk, r1, r2, _c_spec(lspec),
        _c_spec(rspec), what="psi_fused_slabs")
    profiling.launched(
        "psi_fused_slabs", loc, e, lflat, rflat,
        lsalts if lflat is not None else None,
        rsalts if rflat is not None else None, slabs)
    return slabs


def _check_rows(name: str, nnz: int, **sides) -> None:
    """Given sides are (r, nnz) in the plan's sorted order, unpadded."""
    for side, rows in sides.items():
        if rows is not None and (rows.ndim != 2 or rows.shape[1] != nnz):
            raise ValueError(f"{name}: {side} of shape {tuple(rows.shape)} "
                             f"for {nnz} entries; rows are (r, nnz) in the "
                             f"plan's sorted order, unpadded")


def _launch_chunk_slabs(name, loc, se, sl, sr, rflat, rsalts, rspec,
                        n_chunks: int, span: int, chunk: int):
    """The slab kernel with a given left side (or none) and a right side
    that is given (``sr``), hashed (``rflat``/``rsalts``/``rspec``) or
    missing."""
    right, rspec = (sr, _GIVEN) if sr is not None else (rflat, rspec)
    r1 = _side_rows(_GIVEN, sl, None)
    r2 = _side_rows(rspec, right, rsalts)
    e = _prepare(se, loc, rflat=rflat,
                 rsalts=rsalts if rflat is not None else None)
    for side, rows in (("sl", sl), ("sr", sr)):
        if rows is not None and (rows.device != e.device
                                 or rows.dtype != torch.float32
                                 or not rows.is_contiguous()):
            raise ValueError(f"{name}: {side} must be a contiguous float32 "
                             f"tensor on {e.device}, got {rows.dtype} on "
                             f"{rows.device}")
    _check_geometry(loc, e, n_chunks, span, chunk)
    _check_shared_memory(name, (sl, _GIVEN, r1), (right, rspec, r2))
    lib = _library()
    slabs = torch.empty((n_chunks, span, r1, r2), dtype=torch.float32,
                        device=e.device)
    cuda_build.launch(
        lib, "tt_psi_chunk_slabs", e.device, loc.data_ptr(), e.data_ptr(),
        _ptr(sl), _ptr(sr), _ptr(rflat),
        _ptr(rsalts if rflat is not None else None), slabs.data_ptr(),
        e.shape[0], n_chunks, span, chunk, r1, r2,
        None if sr is not None else _c_spec(rspec), what=name)
    profiling.launched(name, loc, e, sl, sr, rflat,
                       rsalts if rflat is not None else None, slabs)
    return slabs


@profiling.spanned("tt.kernel.psi_chunk_slabs")
def psi_chunk_slabs(loc, se, sl, sr, n_chunks: int, span: int,
                    chunk: int) -> torch.Tensor:
    """Per-chunk Ψ slabs ``(n_chunks, span, r1, r2)`` float32 from rows that
    are given: ``slab[c, s, i, k] = Σ_{j in chunk c, loc[j] = s}
    e[j]·sl[i, j]·sr[k, j]``.

    ``loc`` (n_chunks·chunk,) int32 local rows (sentinel ``span``), ``se``
    (nnz,) sorted entries, ``sl`` (r1, nnz) and ``sr`` (r2, nnz) float32
    rows in the plan's sorted order, unpadded; either may be None (a row of
    ones: ``r1 = 1`` or ``r2 = 1``).  Counted as
    ``launches.psi_chunk_slabs``."""
    if sl is None and sr is None:
        raise ValueError("psi_chunk_slabs needs a left or a right side")
    _check_rows("psi_chunk_slabs", se.shape[0], sl=sl, sr=sr)
    if _on_cpu(loc, se, sl, sr):
        return psi_chunk_slabs_reference(loc, se, sl, sr, n_chunks, span,
                                         chunk)
    return _launch_chunk_slabs("psi_chunk_slabs", loc, se, sl, sr, None,
                               None, _GAUSS, n_chunks, span, chunk)


@profiling.spanned("tt.kernel.psi_chunk_slabs_genright")
def psi_chunk_slabs_genright(loc, se, sl, rflat, rsalts, n_chunks: int,
                             span: int, chunk: int,
                             rspec=_GAUSS) -> torch.Tensor:
    """Per-chunk Ψ slabs ``(n_chunks, span, r1, r2)`` float32 with the left
    rows given (``sl`` (r1, nnz) float32, sorted, unpadded; None: a row of
    ones) and the right rows hashed in the kernel from ``rflat`` (nnz,)
    int64, ``rsalts`` and ``rspec`` (module docstring).  The swapped case
    (hashed left, given right) is the same call with the roles exchanged
    and each slab block transposed by the caller.
    Counted as ``launches.psi_chunk_slabs_genright``."""
    if rflat is None:
        raise ValueError("psi_chunk_slabs_genright needs the hashed side's "
                         "flat indices")
    _check_rows("psi_chunk_slabs_genright", se.shape[0], sl=sl)
    _side_rows(rspec, rflat, rsalts)  # checks the spec against its salts
    if _on_cpu(loc, se, sl, rflat, rsalts):
        return psi_chunk_slabs_genright_reference(
            loc, se, sl, rflat, rsalts, n_chunks, span, chunk, rspec)
    return _launch_chunk_slabs("psi_chunk_slabs_genright", loc, se, sl,
                               None, rflat, rsalts, rspec, n_chunks, span,
                               chunk)


@profiling.spanned("tt.kernel.psi_window_direct")
def psi_window_direct(win, first, loc, se, lflat, rflat, lsalts, rsalts,
                      n_chunks: int, span: int, chunk: int, n_windows: int,
                      lspec=_GAUSS, rspec=_GAUSS) -> torch.Tensor:
    """Finished Ψ rows ``(n_windows·span, r1, r2)`` float32 of an
    aligned-window plan: row ``j`` of the mode lies at ``j`` (window
    ``j // span``, local row ``j % span``); rows past the mode end are zero.

    ``win``/``first`` (n_chunks,) int32 (``WindowPlan.chunk_window`` /
    ``chunk_first``); ``loc``, ``se`` and the flats are the plan's padded
    streams of ``n_chunks·chunk`` slots (pads: ``loc == span``, entry 0).
    Either side may be None (the one-sided variant of the boundary modes).
    A two-sided call gives each window a block, a one-sided one a warp;
    either writes each of the window's rows once, and no combine follows.
    Counted as ``launches.psi_window_direct``."""
    if lflat is None and rflat is None:
        raise ValueError("psi_window_direct needs a left or a right side")
    r1 = _side_rows(lspec, lflat, lsalts)
    r2 = _side_rows(rspec, rflat, rsalts)
    n_pad = n_chunks * chunk
    for name, t in (("loc", loc), ("entries", se), ("lflat", lflat),
                    ("rflat", rflat)):
        if t is not None and t.shape[0] != n_pad:
            raise ValueError(f"{name} has {t.shape[0]} slots, the window "
                             f"plan {n_chunks} x {chunk}")
    if win.shape[0] != n_chunks or first.shape[0] != n_chunks:
        raise ValueError(f"win/first must have {n_chunks} entries")
    if _on_cpu(win, first, loc, se, lflat, rflat, lsalts, rsalts):
        return psi_window_direct_reference(
            win, first, loc, se, lflat, rflat, lsalts, rsalts, n_chunks,
            span, chunk, n_windows, lspec, rspec)
    e = _prepare(se, loc, lflat=lflat, rflat=rflat,
                 lsalts=lsalts if lflat is not None else None,
                 rsalts=rsalts if rflat is not None else None)
    for name, t in (("win", win), ("first", first)):
        if (t.device != e.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{e.device}, got {t.dtype} on {t.device}")
    _check_shared_memory("psi_window_direct", (lflat, lspec, r1),
                         (rflat, rspec, r2))
    lib = _library()
    psi = torch.empty((n_windows * span, r1, r2), dtype=torch.float32,
                      device=e.device)
    cuda_build.launch(
        lib, "tt_psi_window_direct", e.device, win.data_ptr(),
        first.data_ptr(), loc.data_ptr(), e.data_ptr(), _ptr(lflat),
        _ptr(rflat), _ptr(lsalts if lflat is not None else None),
        _ptr(rsalts if rflat is not None else None), psi.data_ptr(),
        n_chunks, span, chunk, n_windows, r1, r2, _c_spec(lspec),
        _c_spec(rspec), what="psi_window_direct")
    profiling.launched(
        "psi_window_direct", win, first, loc, e, lflat, rflat,
        lsalts if lflat is not None else None,
        rsalts if rflat is not None else None, psi)
    return psi


def oneside_schedule(window: bool, lflat, rflat, r1: int, r2: int,
                     lspec=_GAUSS, rspec=_GAUSS, n: int = 1):
    """``(bucket, threads a block, blocks, windows a block)`` that a call of
    ``psi_fused_slabs`` (``window`` False, ``n`` its chunks) or of
    ``psi_window_direct`` (``n`` its windows) takes on the current card:
    ``bucket`` is the rows the one-sided instance holds in registers, 0
    where the tiled block program serves the call (two sides, or more than
    32 rows).  Needs a card."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    err = lib.tt_psi_oneside_schedule(
        int(window), int(lflat is not None), int(rflat is not None), r1, r2,
        _c_spec(lspec), _c_spec(rspec), n, out)
    cuda_build.check(lib, err, "tt_psi_oneside_schedule")
    return tuple(out)


@profiling.spanned("tt.kernel.omega_fused")
def omega_fused(e, lflat, rflat, lsalts, rsalts, lspec=_GAUSS,
                rspec=_GAUSS) -> torch.Tensor:
    """(r1, r2) float32 Ω block ``Σ_k e_k·L[:,k] ⊗ R[:,k]`` with both row
    families hashed in-kernel, in nnz order.  Per-block partials are summed
    by ``torch.sum`` in a fixed order.  Counted as
    ``launches.omega_fused``."""
    r1 = _side_rows(lspec, lflat, lsalts)
    r2 = _side_rows(rspec, rflat, rsalts)
    if _on_cpu(e, lflat, rflat, lsalts, rsalts):
        return omega_fused_reference(e, lflat, rflat, lsalts, rsalts, lspec,
                                     rspec)
    e = _prepare(e, lflat=lflat, rflat=rflat, lsalts=lsalts, rsalts=rsalts)
    _check_shared_memory("omega_fused", (lflat, lspec, r1),
                         (rflat, rspec, r2))
    lib = _library()
    n_blocks = -(-e.shape[0] // lib.tt_omega_chunk())
    part = torch.empty((n_blocks, r1, r2), dtype=torch.float32,
                       device=e.device)
    cuda_build.launch(
        lib, "tt_omega_fused", e.device, e.data_ptr(), lflat.data_ptr(),
        rflat.data_ptr(), lsalts.data_ptr(), rsalts.data_ptr(),
        part.data_ptr(), e.shape[0], r1, r2, _c_spec(lspec), _c_spec(rspec),
        what="omega_fused")
    profiling.launched("omega_fused", e, lflat, rflat, lsalts, rsalts, part)
    return part.sum(dim=0)


@profiling.spanned("tt.kernel.psi_omega_merged_slabs")
def psi_omega_merged_slabs(loc, se, lflat, rflat, oflat, lsalts, rsalts,
                           osalts, n_chunks: int, span: int, chunk: int,
                           lspec=_GAUSS, rspec=_GAUSS,
                           ospec=_GAUSS) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass computing the Ψ_μ slabs (as ``psi_fused_slabs``) and the
    Ω_μ block ``(r1o, r2)`` from the inclusive-prefix rows ``oflat`` /
    ``osalts`` / ``ospec``, with the right rows hashed once for both.
    ``lflat`` may be None (μ = 0).  Counted as
    ``launches.psi_omega_merged_slabs``."""
    r1 = _side_rows(lspec, lflat, lsalts)
    r2 = _side_rows(rspec, rflat, rsalts)
    r1o = _side_rows(ospec, oflat, osalts)
    if _on_cpu(loc, se, lflat, rflat, oflat, lsalts, rsalts, osalts):
        return psi_omega_merged_slabs_reference(
            loc, se, lflat, rflat, oflat, lsalts, rsalts, osalts, n_chunks,
            span, chunk, lspec, rspec, ospec)
    e = _prepare(se, loc, lflat=lflat, rflat=rflat, oflat=oflat,
                 lsalts=lsalts if lflat is not None else None,
                 rsalts=rsalts, osalts=osalts)
    _check_geometry(loc, e, n_chunks, span, chunk)
    _check_shared_memory("psi_omega_merged_slabs", (lflat, lspec, r1),
                         (rflat, rspec, r2), (oflat, ospec, r1o))
    lib = _library()
    slabs = torch.empty((n_chunks, span, r1, r2), dtype=torch.float32,
                        device=e.device)
    part = torch.empty((n_chunks, r1o, r2), dtype=torch.float32,
                       device=e.device)
    cuda_build.launch(
        lib, "tt_psi_omega_merged", e.device, loc.data_ptr(), e.data_ptr(),
        _ptr(lflat), rflat.data_ptr(), oflat.data_ptr(),
        _ptr(lsalts if lflat is not None else None), rsalts.data_ptr(),
        osalts.data_ptr(), slabs.data_ptr(), part.data_ptr(), e.shape[0],
        n_chunks, span, chunk, r1, r2, r1o, _c_spec(lspec), _c_spec(rspec),
        _c_spec(ospec), what="psi_omega_merged_slabs")
    profiling.launched(
        "psi_omega_merged_slabs", loc, e, lflat, rflat, oflat,
        lsalts if lflat is not None else None, rsalts, osalts, slabs, part)
    return slabs, part.sum(dim=0)
