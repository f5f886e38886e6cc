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

Every launch decision is made here, by the pure function
``chain_schedule`` (tested on the CPU): the core's layout in rows of
16-byte quads (the kernel packs them into scratch the wrapper allocates)
and its padded row stride, the register buckets of the ranks (a rank past
the largest bucket takes the kernel's generic instance), and where the
core lives: in each block's shared memory up to ``BLOCK_BUDGET`` bytes,
read through the cache above.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.kernels import cuda_build
from tt_sketch_torch.kernels.cuda_build import I32, I64, PTR

#: nonzeros per step of the plain version (bounds the gathered
#: ``(r1, block, r2)`` temporary)
_REF_BLOCK = 1 << 18

#: dtypes the kernel contract covers (float32 arithmetic: the CUDA kernel on
#: the card, the plain version on the CPU); float64 is the parity path, the
#: plain einsum on whichever device
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: register buckets of the kernel's templates (``csrc/chain_step.cu``): the
#: state's rank padded to even, and the first step's row (padded to 4) or
#: a step's output rank padded to even
R1_BUCKETS = (4, 8, 16, 32)
R2_BUCKETS = (4, 8, 12, 16, 32)
#: the largest core a block holds in its shared memory, in bytes: two
#: blocks an SM.  On an H100 a core staged so beat the cache up to 80 KB and
#: lost to it at 160 KB, one block an SM (``chip_smoke.py`` phase 10's
#: placements)
BLOCK_BUDGET = 96 * 1024
#: threads of a block (the kernel's ``THREADS``)
THREADS = 256
#: shared memory the generic instance stages state columns in
GENERIC_STATE_BYTES = 64 * 1024
#: where the core lives, as the kernel numbers it
PLACES = {"block": 0, "cache": 1}


class ChainSchedule(NamedTuple):
    """The launch decisions of one chain step (``chain_schedule``)."""

    first: bool
    row: int            # floats of a row's data (ranks padded)
    stride: int         # floats between rows: a multiple of 4, odd in quads
    r1_bucket: int      # 0 with r2_bucket 0: the generic instance
    r2_bucket: int
    place: str          # "block" or "cache"
    smem_bytes: int     # dynamic shared memory of a block
    state_cols: int     # generic step: nonzeros whose state a block stages


def _bucket(v, buckets):
    return next((b for b in buckets if v <= b), 0)


def chain_schedule(n: int, r1: int, r2: int, first: bool) -> ChainSchedule:
    """Where and how the kernel runs one step of a core ``(r1, n, r2)``.

    The core is laid out in rows of 16-byte quads: the first step's row is
    ``core[0, row, :]`` padded to a multiple of 4 floats; quad
    ``i2 * nk2 + k2`` of a step's row holds ``core[2i2 + di, row, 2k2 +
    dk]`` at ``2·dk + di`` (ranks padded to even with zeros), so one
    16-byte load feeds two outputs over two state values in increasing
    ``i``.
    The row stride adds one quad when the row has an even number of them,
    so rows start on every bank quad.  A row's floats pick the register
    buckets; a rank past the largest takes the generic instance, which
    reads the core through the cache and stages the state of
    ``state_cols`` nonzeros.  Otherwise a core of at most ``BLOCK_BUDGET``
    bytes lives in each block's shared memory and a larger one is read
    through the cache."""
    if first:
        row = 4 * math.ceil(r2 / 4)
        b1, b2 = (1, _bucket(row, R2_BUCKETS))
    else:
        r1e, r2e = 2 * math.ceil(r1 / 2), 2 * math.ceil(r2 / 2)
        row = r1e * r2e
        b1, b2 = _bucket(r1e, R1_BUCKETS), _bucket(r2e, R2_BUCKETS)
    stride = row if (row // 4) % 2 else row + 4
    row_bytes = 4 * stride
    if b1 == 0 or b2 == 0:
        cols = 0
        if not first:
            cols = min(THREADS, max(1, GENERIC_STATE_BYTES // (4 * r1)))
            cols = cols // 32 * 32 if cols >= 32 else cols
        return ChainSchedule(first, row, stride, 0, 0, "cache",
                             4 * r1 * cols, cols)
    if n * row_bytes <= BLOCK_BUDGET:
        return ChainSchedule(first, row, stride, b1, b2, "block",
                             n * row_bytes, 0)
    return ChainSchedule(first, row, stride, b1, b2, "cache", 0, 0)


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
def _library():
    """The built kernel library with its C signatures declared (once per
    process)."""
    return cuda_build.library("chain_step", {
        "tt_chain_step": ([PTR] * 5 + [I64] + [I32] * 9 + [PTR], I32),
    })


@profiling.spanned("tt.kernel.chain_step_t")
def chain_step_t(state_t: Optional[torch.Tensor], core: torch.Tensor,
                 indices_mu: torch.Tensor) -> torch.Tensor:
    """One transposed chain step: the ``(r2, nnz)`` state from the
    ``(r1, nnz)`` state ``state_t`` (None on the first mode, whose core has
    ``r1 == 1``), the TT core ``core`` ``(r1, n, r2)`` and the nonzeros'
    int64 indices ``indices_mu`` ``(nnz,)`` into the mode.

    CPU tensors take ``chain_step_t_reference``; CUDA float32/bfloat16
    tensors launch the kernel (counted as ``launches.chain_step_t``).
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
    if nnz == 0:
        return torch.empty((r2, 0), dtype=core.dtype, device=device)
    sched = chain_schedule(n, r1, r2, state_t is None)
    return _launch(state_t, core, indices_mu.contiguous(), sched)


def _launch(state_t: Optional[torch.Tensor], core: torch.Tensor,
            idx: torch.Tensor, sched: ChainSchedule) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands with the decisions
    ``sched`` (``chain_step_t`` passes ``chain_schedule``'s)."""
    r1, n, r2 = core.shape
    nnz = idx.shape[0]
    device = core.device
    out = torch.empty((r2, nnz), dtype=torch.float32, device=device)
    # scratch for the core in rows of quads, written by the kernel's pack
    rows = torch.empty((n, sched.stride), dtype=torch.float32, device=device)
    core32 = core.to(torch.float32).contiguous()
    state = (None if state_t is None
             else state_t.to(torch.float32).contiguous())
    cuda_build.launch(
        _library(), "tt_chain_step", device,
        None if state is None else state.data_ptr(), core32.data_ptr(),
        rows.data_ptr(), idx.data_ptr(), out.data_ptr(), nnz, n, r1, r2,
        sched.stride, sched.r1_bucket, sched.r2_bucket, PLACES[sched.place],
        sched.smem_bytes, sched.state_cols, what="chain_step_t")
    profiling.launched("chain_step_t", state, core32, idx, out)
    return out.to(core.dtype)

