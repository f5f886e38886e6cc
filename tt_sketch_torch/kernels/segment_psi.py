"""The Ψ segment reduction of a mode without a sort/chunk plan:

    Ψ[n, a, b] = Σ_{k : idx[k] = n}  left[a, k] · entries[k] · right[b, k]

Counterpart of the segment reduction in
``tt_sketch_tpu/kernels/sketch_kernels.py`` (``_psi_sparse_segment``),
which sums with ``jax.ops.segment_sum`` off a TPU and with a one-hot
product on one (a TPU workaround).  On CUDA tensors ``psi_segment``
launches the hand-written kernel of ``tt_sketch_torch/csrc/segment_psi.cu``
(built at first use, see ``cuda_build``) or raises; on CPU tensors it
computes the plain version ``psi_segment_reference``: the chunked outer
products summed with ``index_add_``, the counterpart of ``segment_sum``.
There is no fallback from one to the other.

The kernel sums in a fixed order, without atomics, into bins in shared
memory: a block holds the bins of every row for a set of micro-tiles of
rank pairs (all of them where they fit; the grid's second dimension takes
the sets).  It takes a Ψ when ``segment_fits``: the bins of one micro-tile
of every row beside a ring of ``MIN_TK`` nonzeros fit ``SMEM_BUDGET``.
A Ψ beyond that (thousands of rows) scatters with ``psi_segment_reference``
on every device (``sketch_kernels._psi_sparse_segment``): its atomics then
spread over that many rows.  A Ψ whose bins leave that budget too short a
ring (fewer than 128 nonzeros a step) is planned within 113 KB a block,
two blocks an SM (``segment_plan`` reads a shape's launch geometry from
the built library).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.kernels import cuda_build
from tt_sketch_torch.kernels.cuda_build import I32, I64, PTR, check_int64

#: the kernel's fit (``csrc/segment_psi.cu``, held to it by a test): its
#: shared memory a block, the nonzeros of its smallest step, the steps of
#: its ring, and the most rank pairs (tiles of pairs take the grid's y)
SMEM_BUDGET = 96 * 1024
MIN_TK = 8
NSTAGE = 2
MAX_PAIRS = 65535
#: nnz per step of the plain version (bounds the outer-product temporary to
#: a few hundred MB at rank 10 x 20)
_REF_CHUNK = 1 << 19
#: the kernel's nonzero ranges: at most this many blocks (on the card: as
#: many as it holds at once, ``tt_segment_psi_blocks``), at least this many
#: nonzeros each, and partial bins of at most this many values
_TARGET_BLOCKS = 1024
_MIN_CHUNK = 1024
_MAX_PARTIALS = 1 << 26


def _ranks(left, right):
    return (1 if left is None else left.shape[0],
            1 if right is None else right.shape[0])


def _wide_tiles(r1: int, r2: int) -> bool:
    """Whether the kernel takes 2 x 4 micro-tiles of rank pairs (else 1 x
    1): the fewer warp instructions a quad of nonzeros, as ``wide_tiles``
    in the kernel's source counts them."""
    def cost(ta, tb):
        tiles = -(-r1 // ta) * -(-r2 // tb)
        return -(-tiles // 32) * (6 + ta + tb + 4 * ta + 4 * ta * tb)
    return cost(2, 4) < cost(1, 1)


@functools.cache
def _fits(elem: int, n_mu: int, r1: int, r2: int) -> bool:
    """``segment_fits`` of ranks ``r1``, ``r2`` in ``elem``-byte values:
    the kernel's block of one micro-tile (its bins of every row) and a ring
    of ``NSTAGE`` steps of ``MIN_TK`` nonzeros (the staged left rows it can
    span, the right rows and the entries, ``MIN_TK`` + one 16-byte quad
    apart, then the step's int64 indices, int rows and quad flags) within
    ``SMEM_BUDGET``."""
    if n_mu <= 0 or r1 <= 0 or r2 <= 0 or r1 * r2 > MAX_PAIRS:
        return False
    ta, tb = (2, 4) if _wide_tiles(r1, r2) else (1, 1)
    nb = -(-r2 // tb)
    la = min(-(-r1 // ta), 1 // nb + 2) * ta
    bins = -(-n_mu * ta * tb * elem // 16) * 16
    stage = ((la + nb * tb + 1) * (MIN_TK + 16 // elem) * elem
             + MIN_TK * 12 + -(-(MIN_TK // 4 * 4) // 16) * 16)
    return bins + NSTAGE * stage <= SMEM_BUDGET


def segment_fits(left, right, n_mu: int, dtype) -> bool:
    """Whether the kernel takes the (n_mu, r1, r2) Ψ of sides ``left``
    (r1, nnz) and ``right`` (r2, nnz) (None: rank 1) in ``dtype`` (it sums
    float64 in float64, anything else in float32): the rule its C entry
    enforces (``tt_segment_psi_fits``), decided without a card."""
    r1, r2 = _ranks(left, right)
    return _fits(8 if dtype == torch.float64 else 4, int(n_mu), r1, r2)


def psi_dtype(left, right, entries):
    """The dtype of the Ψ: the operands' promoted dtype."""
    dtype = entries.dtype
    for side in (left, right):
        if side is not None:
            dtype = torch.promote_types(dtype, side.dtype)
    return dtype


def psi_segment_reference(left, right, entries, indices_mu, n_mu):
    """Plain PyTorch version: the outer products of ``_REF_CHUNK`` nonzeros
    at a time, summed into their rows with ``index_add_``, in the promoted
    dtype of the operands.  An index outside ``[0, n_mu)`` is dropped (as
    ``jax.ops.segment_sum`` drops it): it adds to a row past the last,
    which is cut off.  Returns (n_mu, r1, r2)."""
    r1, r2 = _ranks(left, right)
    dtype = psi_dtype(left, right, entries)
    psi = torch.zeros((n_mu + 1, r1, r2), dtype=dtype, device=entries.device)
    for k0 in range(0, entries.shape[0], _REF_CHUNK):
        sl = slice(k0, k0 + _REF_CHUNK)
        ent = entries[sl].to(dtype)
        weighted = (ent[None, :] if left is None
                    else left[:, sl].to(dtype) * ent)
        if right is None:
            outer = weighted.T[:, :, None]
        else:
            rows = right[:, sl].to(dtype)
            outer = weighted.T[:, :, None] * rows.T[:, None, :]
        idx = indices_mu[sl]
        psi.index_add_(0, torch.where((idx >= 0) & (idx < n_mu), idx, n_mu),
                       outer)
    return psi[:n_mu]


def segment_chunks(nnz: int, n_mu: int, n_pairs: int,
                   blocks: int = _TARGET_BLOCKS) -> tuple:
    """``(chunk, n_chunks)``: the kernel's blocks each take ``chunk``
    consecutive nonzeros, a multiple of 4 (so that a block's range starts
    on a 16-byte boundary of every row); at most ``blocks`` of them (one
    wave: as many as the card holds at once), none shorter than
    ``_MIN_CHUNK`` unless there are fewer nonzeros, and the partial bins
    ``n_chunks * n_mu * n_pairs`` at most ``_MAX_PARTIALS`` values."""
    n_chunks = min(nnz // _MIN_CHUNK, blocks,
                   _MAX_PARTIALS // (n_mu * n_pairs))
    n_chunks = max(1, n_chunks)
    chunk = -(-max(1, -(-nnz // n_chunks)) // 4) * 4
    return chunk, max(1, -(-nnz // chunk))


@functools.cache
def _library():
    """The built kernel library with its C signatures declared (once per
    process)."""
    return cuda_build.library("segment_psi", {
        "tt_segment_psi": ([I32] + [PTR] * 6 + [I64, I32, I32, I32, I64, I32,
                                                PTR], I32),
        "tt_segment_psi_blocks": ([I32] * 4, I32),
        "tt_segment_psi_fits": ([I32] * 4, I32),
        "tt_segment_psi_plan": ([I32] * 4 + [PTR], I32),
    })


@functools.cache
def _blocks(device: torch.device, elem: int, n_mu: int, r1: int,
            r2: int) -> int:
    """The kernel's blocks that fill card ``device`` once for this Ψ."""
    with cuda_build.on_device(device):
        return _library().tt_segment_psi_blocks(elem, n_mu, r1, r2)


#: the fields of ``segment_plan``, as ``tt_segment_psi_plan`` writes them
PLAN_FIELDS = ("ta", "tb", "tiles_a_block", "threads", "tk", "grid_y",
               "smem_bytes", "tiles")


def segment_plan(elem: int, n_mu: int, r1: int, r2: int) -> dict:
    """The kernel's launch geometry for a Ψ of (n_mu, r1, r2) in
    ``elem``-byte values (``PLAN_FIELDS``, and ``fits``), from the built
    library; asks no card."""
    geometry = (ctypes.c_int * len(PLAN_FIELDS))()
    fits = _library().tt_segment_psi_plan(elem, n_mu, r1, r2, geometry)
    return dict(zip(PLAN_FIELDS, geometry), fits=bool(fits))


@profiling.spanned("tt.kernel.psi_segment")
def psi_segment(left, right, entries, indices_mu, n_mu):
    """(n_mu, r1, r2) Ψ that ``segment_fits`` from its sides ``left``
    (r1, nnz) and ``right`` (r2, nnz) (either may be None: rank 1, a factor
    of 1), the ``entries`` (nnz,) and the int64 mode indices (nnz,), in the
    operands' promoted dtype.

    CPU tensors take ``psi_segment_reference``.  CUDA tensors launch the
    kernel in float64 for float64 operands and in float32 otherwise
    (counted as ``launches.psi_segment``; no nonzeros, no launch);
    indices outside ``[0, n_mu)`` are dropped there."""
    n_mu = int(n_mu)
    if not segment_fits(left, right, n_mu,
                        psi_dtype(left, right, entries)):
        raise ValueError(f"psi_segment: a Ψ of {n_mu} rows and ranks "
                         f"{_ranks(left, right)} beyond the kernel's fit")
    named = [(n, t) for n, t in (("left", left), ("right", right),
                                 ("entries", entries),
                                 ("indices_mu", indices_mu))
             if t is not None]
    if all(t.device.type == "cpu" for _, t in named):
        return psi_segment_reference(left, right, entries, indices_mu, n_mu)
    device = entries.device
    if device.type != "cuda":
        raise ValueError(f"psi_segment: entries lie on {device}; all operands "
                         f"must lie on one CUDA device")
    check_int64("indices_mu", indices_mu, device)
    nnz = entries.shape[0]
    for name, t in named:
        if t.device != device:
            raise ValueError(f"psi_segment: {name} lies on {t.device}; all "
                             f"operands must lie on one CUDA device")
        if t.shape[-1] != nnz or t.ndim != (2 if name in ("left", "right")
                                             else 1):
            raise ValueError(f"psi_segment: {name} of shape "
                             f"{tuple(t.shape)} for {nnz} nonzeros")
    dtype = psi_dtype(left, right, entries)
    kdtype = torch.float64 if dtype == torch.float64 else torch.float32
    left, right, entries = (None if t is None else t.to(kdtype).contiguous()
                            for t in (left, right, entries))
    r1, r2 = _ranks(left, right)
    if nnz == 0:
        return torch.zeros((n_mu, r1, r2), dtype=dtype, device=device)
    lib = _library()
    elem = torch.finfo(kdtype).bits // 8
    chunk, n_chunks = segment_chunks(
        nnz, n_mu, r1 * r2, _blocks(device, elem, n_mu, r1, r2))
    out = torch.empty((n_mu, r1, r2), dtype=kdtype, device=device)
    partials = torch.empty((n_chunks, n_mu, r1 * r2), dtype=kdtype,
                           device=device)
    cuda_build.launch(
        lib, "tt_segment_psi", device, elem, indices_mu.data_ptr(),
        entries.data_ptr(), None if left is None else left.data_ptr(),
        None if right is None else right.data_ptr(), partials.data_ptr(),
        out.data_ptr(), nnz, n_mu, r1, r2, chunk, n_chunks,
        what="psi_segment")
    profiling.launched("psi_segment", indices_mu, entries, left, right, out)
    return out.to(dtype)

