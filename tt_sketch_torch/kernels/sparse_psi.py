"""Fused sparse Ψ/Ω contractions with lazy-Gaussian DRM rows hashed inside
the kernel.

Counterpart of ``tt_sketch_tpu/kernels/pallas_psi.py`` for Gaussian sides:
``psi_fused_slabs``, ``omega_fused`` and ``psi_omega_merged_slabs``.  On
CUDA tensors each launches its hand-written kernel of
``tt_sketch_torch/csrc/sparse_psi.cu`` (built at first use, see
``cuda_build``) or raises; on CPU tensors it computes its plain version
(``*_reference``).  There is no fallback from one to the other.

Layouts are the port's own: slabs are ``(n_chunks, span, r1, r2)`` float32
with ``r1 = 1`` without a left side and ``r2 = 1`` without a right side, and
ranks are not padded (the TPU kernels pad them to multiples of 8).  A side
is described by its int64 flat indices (the plan's ``flat_left`` etc.) and
its int64 column salts (``hash_rng.drm_salts``).  The sparse-sign side spec
``("s", ...)`` of the JAX package comes with the sparse-sign slice.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tt_sketch_torch.kernels.lazy_gaussian import (
    _check_int64,
    _raise_on,
    lazy_gaussian_reference,
)

_GAUSS = ("g",)

#: nnz per step of the plain versions (bounds their temporaries)
_REF_BLOCK = 1 << 18


def _check_spec(*specs) -> None:
    for spec in specs:
        if tuple(spec) != _GAUSS:
            raise NotImplementedError(
                f"side spec {spec!r}: only lazy-Gaussian sides ('g',) are "
                f"ported; sparse-sign sides come with the sparse-sign slice")


def _rows(flat, salts, n, like, weight=None):
    """(r, n) rows of one side, or a row of ones for a missing side; the
    entries ``weight`` scale them when given."""
    if flat is None:
        rows = torch.ones((1, n), dtype=torch.float32, device=like.device)
    else:
        rows = lazy_gaussian_reference(flat, salts)
    return rows if weight is None else rows * weight


# -- plain versions ----------------------------------------------------------

def psi_fused_slabs_reference(loc, se, lflat, rflat, lsalts, rsalts,
                              n_chunks: int, span: int,
                              chunk: int) -> torch.Tensor:
    """Plain PyTorch version of ``psi_fused_slabs``: hashed rows, outer
    products, and an ``index_add_`` into slab rows (sentinel ``loc == span``
    goes to a dump row that is dropped)."""
    nnz = se.shape[0]
    r1 = 1 if lflat is None else lsalts.shape[0]
    r2 = 1 if rflat is None else rsalts.shape[0]
    out = torch.zeros((n_chunks * (span + 1), r1 * r2), dtype=torch.float32,
                      device=se.device)
    for k0 in range(0, nnz, _REF_BLOCK):
        sl = slice(k0, min(k0 + _REF_BLOCK, nnz))
        n = sl.stop - k0
        e = se[sl].to(torch.float32)
        L = _rows(None if lflat is None else lflat[sl], lsalts, n, e, e)
        R = _rows(None if rflat is None else rflat[sl], rsalts, n, e)
        outer = (L.T[:, :, None] * R.T[:, None, :]).reshape(n, r1 * r2)
        k = torch.arange(k0, sl.stop, device=se.device)
        row = (k // chunk) * (span + 1) + loc[sl].to(torch.int64).clamp(
            0, span)
        out.index_add_(0, row, outer)
    return out.reshape(n_chunks, span + 1, r1, r2)[:, :span].contiguous()


def omega_fused_reference(e, lflat, rflat, lsalts, rsalts) -> torch.Tensor:
    """Plain PyTorch version of ``omega_fused``: ``(L·e) @ Rᵀ`` in nnz
    blocks, float32."""
    om = torch.zeros((lsalts.shape[0], rsalts.shape[0]), dtype=torch.float32,
                     device=e.device)
    for k0 in range(0, e.shape[0], _REF_BLOCK):
        sl = slice(k0, k0 + _REF_BLOCK)
        ek = e[sl].to(torch.float32)
        L = lazy_gaussian_reference(lflat[sl], lsalts) * ek
        om += L @ lazy_gaussian_reference(rflat[sl], rsalts).T
    return om


def psi_omega_merged_slabs_reference(loc, se, lflat, rflat, oflat, lsalts,
                                     rsalts, osalts, n_chunks: int,
                                     span: int, chunk: int):
    """Plain PyTorch version of ``psi_omega_merged_slabs``."""
    slabs = psi_fused_slabs_reference(loc, se, lflat, rflat, lsalts, rsalts,
                                      n_chunks, span, chunk)
    return slabs, omega_fused_reference(se, oflat, rflat, osalts, rsalts)


# -- kernels -----------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (once per
    process)."""
    from tt_sketch_torch.kernels.cuda_build import load_library

    lib = load_library("sparse_psi")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.tt_psi_fused_slabs.argtypes = (
        [ptr] * 7 + [i64] + [i32] * 5 + [ptr])
    lib.tt_psi_fused_slabs.restype = i32
    lib.tt_omega_fused.argtypes = [ptr] * 6 + [i64, i32, i32, ptr]
    lib.tt_omega_fused.restype = i32
    lib.tt_psi_omega_merged.argtypes = (
        [ptr] * 10 + [i64] + [i32] * 6 + [ptr])
    lib.tt_psi_omega_merged.restype = i32
    for fn in ("tt_sparse_psi_tile", "tt_omega_chunk",
               "tt_sparse_psi_smem_limit"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i32
    lib.tt_cuda_error_string.argtypes = [i32]
    lib.tt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _prepare(se, loc=None, **int64s):
    """Check the kernel operands; returns the entries as float32."""
    device = se.device
    if device.type != "cuda":
        raise ValueError(f"sparse_psi: no kernel for {device}")
    for name, t in int64s.items():
        if t is not None:
            _check_int64(name, t, device)
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


def psi_fused_slabs(loc, se, lflat, rflat, lsalts, rsalts, n_chunks: int,
                    span: int, chunk: int, lspec=_GAUSS,
                    rspec=_GAUSS) -> torch.Tensor:
    """Per-chunk Ψ slabs ``(n_chunks, span, r1, r2)`` float32, DRM rows
    hashed at the plan's sorted order.

    ``loc`` (n_chunks·chunk,) int32 local rows (sentinel ``span``), ``se``
    (nnz,) sorted entries, ``lflat``/``rflat`` (nnz,) int64 flat indices
    (either may be None: boundary modes), ``lsalts``/``rsalts`` int64 column
    salts.  ``psi_fused_slabs.launches`` counts kernel launches."""
    _check_spec(lspec, rspec)
    if lflat is None and rflat is None:
        raise ValueError("psi_fused_slabs needs a left or a right side")
    if _on_cpu(loc, se, lflat, rflat, lsalts, rsalts):
        return psi_fused_slabs_reference(loc, se, lflat, rflat, lsalts,
                                         rsalts, n_chunks, span, chunk)
    e = _prepare(se, loc, lflat=lflat, rflat=rflat,
                 lsalts=lsalts if lflat is not None else None,
                 rsalts=rsalts if rflat is not None else None)
    _check_geometry(loc, e, n_chunks, span, chunk)
    r1 = 1 if lflat is None else lsalts.shape[0]
    r2 = 1 if rflat is None else rsalts.shape[0]
    lib = _library()
    slabs = torch.empty((n_chunks, span, r1, r2), dtype=torch.float32,
                        device=e.device)
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tt_psi_fused_slabs(
            loc.data_ptr(), e.data_ptr(), _ptr(lflat), _ptr(rflat),
            _ptr(lsalts if lflat is not None else None),
            _ptr(rsalts if rflat is not None else None), slabs.data_ptr(),
            e.shape[0], n_chunks, span, chunk, r1, r2, stream)
    _raise_on(lib, err, "psi_fused_slabs")
    psi_fused_slabs.launches += 1
    return slabs


psi_fused_slabs.launches = 0


def omega_fused(e, lflat, rflat, lsalts, rsalts, lspec=_GAUSS,
                rspec=_GAUSS) -> torch.Tensor:
    """(r1, r2) float32 Ω block ``Σ_k e_k·L[:,k] ⊗ R[:,k]`` with both row
    families hashed in-kernel, in nnz order.  Per-block partials are summed
    by ``torch.sum`` in a fixed order.  ``omega_fused.launches`` counts
    kernel launches."""
    _check_spec(lspec, rspec)
    if _on_cpu(e, lflat, rflat, lsalts, rsalts):
        return omega_fused_reference(e, lflat, rflat, lsalts, rsalts)
    e = _prepare(e, lflat=lflat, rflat=rflat, lsalts=lsalts, rsalts=rsalts)
    lib = _library()
    r1, r2 = lsalts.shape[0], rsalts.shape[0]
    n_blocks = -(-e.shape[0] // lib.tt_omega_chunk())
    part = torch.empty((n_blocks, r1, r2), dtype=torch.float32,
                       device=e.device)
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tt_omega_fused(
            e.data_ptr(), lflat.data_ptr(), rflat.data_ptr(),
            lsalts.data_ptr(), rsalts.data_ptr(), part.data_ptr(),
            e.shape[0], r1, r2, stream)
    _raise_on(lib, err, "omega_fused")
    omega_fused.launches += 1
    return part.sum(dim=0)


omega_fused.launches = 0


def psi_omega_merged_slabs(loc, se, lflat, rflat, oflat, lsalts, rsalts,
                           osalts, n_chunks: int, span: int, chunk: int,
                           lspec=_GAUSS, rspec=_GAUSS,
                           ospec=_GAUSS) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass computing the Ψ_μ slabs (as ``psi_fused_slabs``) and the
    Ω_μ block ``(r1o, r2)`` from the inclusive-prefix rows ``oflat`` /
    ``osalts``, with the right rows hashed once for both.  ``lflat`` may be
    None (μ = 0).  ``psi_omega_merged_slabs.launches`` counts launches."""
    _check_spec(lspec, rspec, ospec)
    if _on_cpu(loc, se, lflat, rflat, oflat, lsalts, rsalts, osalts):
        return psi_omega_merged_slabs_reference(
            loc, se, lflat, rflat, oflat, lsalts, rsalts, osalts, n_chunks,
            span, chunk)
    e = _prepare(se, loc, lflat=lflat, rflat=rflat, oflat=oflat,
                 lsalts=lsalts if lflat is not None else None,
                 rsalts=rsalts, osalts=osalts)
    _check_geometry(loc, e, n_chunks, span, chunk)
    r1 = 1 if lflat is None else lsalts.shape[0]
    r2, r1o = rsalts.shape[0], osalts.shape[0]
    lib = _library()
    slabs = torch.empty((n_chunks, span, r1, r2), dtype=torch.float32,
                        device=e.device)
    part = torch.empty((n_chunks, r1o, r2), dtype=torch.float32,
                       device=e.device)
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tt_psi_omega_merged(
            loc.data_ptr(), e.data_ptr(), _ptr(lflat), rflat.data_ptr(),
            oflat.data_ptr(), _ptr(lsalts if lflat is not None else None),
            rsalts.data_ptr(), osalts.data_ptr(), slabs.data_ptr(),
            part.data_ptr(), e.shape[0], n_chunks, span, chunk, r1, r2, r1o,
            stream)
    _raise_on(lib, err, "psi_omega_merged_slabs")
    psi_omega_merged_slabs.launches += 1
    return slabs, part.sum(dim=0)


psi_omega_merged_slabs.launches = 0
