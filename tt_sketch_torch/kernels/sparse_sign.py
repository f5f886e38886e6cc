"""Sparse-sign DRM rows ``(rank_max - rank_min, N)`` from flat indices and
column salts.

Counterpart of ``tt_sketch_tpu/kernels/pallas_rng.py``
(``_generate_sign_pairs`` / ``sparse_sign_pallas_from_pairs``).  On CUDA
tensors ``sparse_sign_rows`` launches the hand-written kernel of
``tt_sketch_torch/csrc/sparse_sign.cu`` (built at first use, see
``cuda_build``) or raises; on CPU tensors it computes the plain version
``sparse_sign_rows_reference``.  There is no fallback from one to the other.
Both give exactly -1, 0 or +1: kernel and plain version agree bit for bit.
The kernel holds a column of rank at most 32 in registers (each draw hashed
once) and a larger one in shared memory (up to rank 5811).

``salts`` are those of columns ``[0, nnz)`` (``hash_rng.drm_salts(0, nnz,
seed)``), not of the rank slice, and are not padded (the JAX package pads
them to a multiple of 8 rows that it hashes and drops).
"""
from __future__ import annotations

import functools

import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.kernels import cuda_build
from tt_sketch_torch.kernels.cuda_build import I32, I64, PTR, check_int64
from tt_sketch_torch.rng.hash_rng import hash_int, sparse_sign_from_bits

#: flat indices per step of the plain version (bounds its (rank, N) block)
_REF_BLOCK = 1 << 20


def check_slice(salts, rank: int, nnz: int, rank_min: int,
                rank_max: int) -> None:
    """Raise unless ``salts`` are those of columns ``[0, nnz)``, ``nnz`` is
    in ``[0, rank]`` and ``[rank_min, rank_max)`` is a non-empty slice of
    the ``rank`` slots."""
    if salts.shape[0] != nnz:
        raise ValueError(f"{salts.shape[0]} salts for {nnz} non-zeros per "
                         f"row: a sign side takes the salts of columns "
                         f"[0, nnz)")
    if not 0 <= nnz <= rank:
        raise ValueError(f"{nnz} non-zeros per row outside [0, rank={rank}]")
    if not 0 <= rank_min < rank_max <= rank:
        raise ValueError(f"rank slice [{rank_min}, {rank_max}) outside "
                         f"[0, {rank}]")


def sparse_sign_rows_reference(flat: torch.Tensor, salts: torch.Tensor,
                               rank: int, nnz: int, rank_min: int,
                               rank_max: int) -> torch.Tensor:
    """Plain PyTorch version: hash, signs from bit 52, Fisher–Yates pass
    with the exact integer swap positions (``hash_rng``), float32."""
    check_slice(salts, rank, nnz, rank_min, rank_max)
    out = torch.empty((rank_max - rank_min, flat.shape[0]),
                      dtype=torch.float32, device=flat.device)
    block = max(1, _REF_BLOCK // max(rank // 16, 1))
    for n0 in range(0, flat.shape[0], block):
        f = flat[n0:n0 + block]
        h = hash_int(f[None, :] + salts[:, None])
        out[:, n0:n0 + block] = sparse_sign_from_bits(h, rank, rank_min,
                                                      rank_max)
    return out


@functools.cache
def _library():
    """The built kernel library with its C signatures declared (once per
    process)."""
    return cuda_build.library("sparse_sign", {
        "tt_sparse_sign_rows": ([PTR, PTR, PTR, I64] + [I32] * 4 + [PTR],
                                I32),
        "tt_sparse_sign_max_rank": ([], I32),
    })


@profiling.spanned("tt.kernel.sparse_sign_rows")
def sparse_sign_rows(flat: torch.Tensor, salts: torch.Tensor, rank: int,
                     nnz: int, rank_min: int, rank_max: int) -> torch.Tensor:
    """(rank_max - rank_min, N) float32 sparse-sign rows for int64 ``flat``
    (N,) and the int64 ``salts`` of columns ``[0, nnz)``: per column
    ``nnz`` hashed ±1 shuffled over ``rank`` slots, slots
    ``[rank_min, rank_max)`` returned.

    CPU tensors take ``sparse_sign_rows_reference``; CUDA tensors launch
    the kernel (counted as ``launches.sparse_sign_rows``)."""
    rank, nnz = int(rank), int(nnz)
    rank_min, rank_max = int(rank_min), int(rank_max)
    if flat.device.type == "cpu" and salts.device.type == "cpu":
        return sparse_sign_rows_reference(flat, salts, rank, nnz, rank_min,
                                          rank_max)
    for name, t in (("flat", flat), ("salts", salts)):
        check_int64(name, t, flat.device)
    if flat.device.type != "cuda":
        raise ValueError(f"sparse_sign_rows: no kernel for {flat.device}")
    check_slice(salts, rank, nnz, rank_min, rank_max)
    lib = _library()
    if rank > lib.tt_sparse_sign_max_rank():
        raise ValueError(f"sparse_sign_rows: rank {rank} > the kernel's "
                         f"{lib.tt_sparse_sign_max_rank()}")
    N = flat.shape[0]
    out = torch.empty((rank_max - rank_min, N), dtype=torch.float32,
                      device=flat.device)
    if N == 0:
        return out
    cuda_build.launch(lib, "tt_sparse_sign_rows", flat.device,
                      flat.data_ptr(), salts.data_ptr(), out.data_ptr(), N,
                      rank, nnz, rank_min, rank_max, what="sparse_sign_rows")
    profiling.launched("sparse_sign_rows", flat, salts, out)
    return out

