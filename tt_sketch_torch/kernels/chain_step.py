"""Sparse TT chain step ``(r1, nnz) → (r2, nnz)`` at the nonzeros' mode
indices.

Counterpart of ``tt_sketch_tpu/kernels/pallas_chain.py`` (``chain_step_t``).
The sequential sketches (HMT, OTTS) and ``TensorTrainDRM.sketch_sparse``
advance a per-nonzero chain state once per mode::

    out[k, j] = Σ_i state_t[i, j] · core[i, idx[j], k]
    out[k, j] = core[0, idx[j], k]            (first step: ``state_t`` None)

On CUDA tensors ``chain_step_t`` launches the hand-written gather kernel of
``tt_sketch_torch/csrc/chain_step.cu`` (built at first use, see
``cuda_build``) or raises; on CPU tensors it computes the plain version
``chain_step_t_reference``.  There is no fallback from one to the other,
and no gate on the mode size, the number of nonzeros or the ranks (the TPU
kernel's one-hot product is gated to ``n ≤ 4096`` and ``nnz ≥ 4096``; a
gather costs the same at any mode size).  The kernel computes in float32;
bfloat16 operands are widened and the result rounded back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tt_sketch_torch.kernels.lazy_gaussian import _raise_on

#: nonzeros per step of the plain version (bounds the gathered
#: ``(r1, block, r2)`` temporary)
_REF_BLOCK = 1 << 18

#: dtypes the kernel contract covers (float32 arithmetic: the CUDA kernel on
#: the card, the plain version on the CPU); float64 is the parity path, the
#: plain einsum on whichever device
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def chain_step_t_reference(state_t: Optional[torch.Tensor],
                           core: torch.Tensor,
                           indices_mu: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather ``core[:, idx, :]`` and contract with
    the state, in blocks of nonzeros; any float dtype, any device."""
    idx = indices_mu.to(torch.int64)
    if state_t is None:
        return core[0].index_select(0, idx).T
    nnz = idx.shape[0]
    out = torch.empty((core.shape[2], nnz), dtype=core.dtype,
                      device=core.device)
    for j0 in range(0, nnz, _REF_BLOCK):
        sl = slice(j0, j0 + _REF_BLOCK)
        out[:, sl] = torch.einsum(
            "ijk,ij->kj", core.index_select(1, idx[sl]), state_t[:, sl])
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (once per
    process)."""
    from tt_sketch_torch.kernels.cuda_build import load_library

    lib = load_library("chain_step")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.tt_chain_step.argtypes = [ptr] * 4 + [i64] + [i32] * 3 + [ptr]
    lib.tt_chain_step.restype = i32
    lib.tt_chain_step_staged_bytes.argtypes = []
    lib.tt_chain_step_staged_bytes.restype = i32
    lib.tt_cuda_error_string.argtypes = [i32]
    lib.tt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def chain_step_t(state_t: Optional[torch.Tensor], core: torch.Tensor,
                 indices_mu: torch.Tensor) -> torch.Tensor:
    """One transposed chain step: the ``(r2, nnz)`` state from the
    ``(r1, nnz)`` state ``state_t`` (None on the first mode, whose core has
    ``r1 == 1``), the TT core ``core`` ``(r1, n, r2)`` and the nonzeros'
    int64 indices ``indices_mu`` ``(nnz,)`` into the mode.

    CPU tensors take ``chain_step_t_reference``; CUDA float32/bfloat16
    tensors launch the kernel (``chain_step_t.launches`` counts launches).
    An index outside ``[0, n)`` gives a zero column on CUDA (the kernel
    reads nothing for it) and raises on the CPU."""
    tensors = [core, indices_mu] + ([] if state_t is None else [state_t])
    r1, n, r2 = core.shape
    nnz = indices_mu.shape[0]
    if state_t is None and r1 != 1:
        raise ValueError(f"the first chain step needs a core of r1 == 1, got "
                         f"{tuple(core.shape)}")
    if state_t is not None and tuple(state_t.shape) != (r1, nnz):
        raise ValueError(f"state of shape {tuple(state_t.shape)}, expected "
                         f"{(r1, nnz)} for a core {tuple(core.shape)}")
    if all(t.device.type == "cpu" for t in tensors):
        return chain_step_t_reference(state_t, core, indices_mu)
    device = core.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"chain_step_t: operands on "
                         f"{[str(t.device) for t in tensors]}; the kernel "
                         f"needs all of them on one CUDA device")
    if core.dtype not in KERNEL_DTYPES or (
            state_t is not None and state_t.dtype != core.dtype):
        raise ValueError(
            f"chain_step_t: the kernel takes float32 or bfloat16 state and "
            f"core of one dtype, got core {core.dtype}"
            + ("" if state_t is None else f" and state {state_t.dtype}"))
    if indices_mu.dtype != torch.int64 or indices_mu.ndim != 1:
        raise ValueError(f"indices must be a 1-D int64 tensor, got "
                         f"{indices_mu.dtype} of shape "
                         f"{tuple(indices_mu.shape)}")
    out = torch.empty((r2, nnz), dtype=torch.float32, device=device)
    if nnz == 0:
        return out.to(core.dtype)
    # the core as (n, r1·r2): one contiguous run per nonzero
    core_t = core.to(torch.float32).permute(1, 0, 2).contiguous()
    state = (None if state_t is None
             else state_t.to(torch.float32).contiguous())
    idx = indices_mu.contiguous()
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tt_chain_step(
            None if state is None else state.data_ptr(), core_t.data_ptr(),
            idx.data_ptr(), out.data_ptr(), nnz, n, r1, r2, stream)
    _raise_on(lib, err, "chain_step_t")
    chain_step_t.launches += 1
    return out.to(core.dtype)


chain_step_t.launches = 0
