"""A request's work from shapes and ranks alone: the bytes it must move
(each input byte read once, each output byte written once; a hashed DRM's
rows cost none) and the flops it must do (its multiply-adds, times two).
Nothing here reads the build or the program."""
from __future__ import annotations

from functools import reduce
from operator import mul

import torch

from ttbench.reference.sparse import trim_ranks

F32 = 4


def itemsize(name: str) -> int:
    """Bytes of one element of the torch type ``name`` (``"int64"``)."""
    return torch.empty(0, dtype=getattr(torch, name)).element_size()


def coo(config: dict):
    """A sparse configuration's COO as it states it: shape, nonzeros, and
    the bytes of an index and of a value."""
    return (config["shape"], int(config["nnz"]),
            itemsize(config["index_dtype"]), itemsize(config["dtype"]))


def prod(xs) -> int:
    return int(reduce(mul, (int(x) for x in xs), 1))


def tt_bytes(shape, ranks, itemsize=F32) -> int:
    r = (1,) + tuple(ranks) + (1,)
    return itemsize * sum(r[k] * int(n) * r[k + 1] for k, n in enumerate(shape))


def drm_bytes(shape, rank: int, itemsize=F32) -> int:
    """The d - 1 cores (r1, n_k, rank) of a TT-DRM, r1 = 1 first."""
    return itemsize * sum((1 if k == 0 else rank) * int(n) * rank
                          for k, n in enumerate(shape[:-1]))


def sketch_bytes(shape, left, right, itemsize=F32) -> int:
    """Psi cores (r_{k-1}, n_k, r'_k) and Omega matrices (r_k, r'_k)."""
    r_in = (1,) + tuple(left)
    r_out = tuple(right) + (1,)
    psi = sum(r_in[k] * int(n) * r_out[k] for k, n in enumerate(shape))
    omega = sum(a * b for a, b in zip(left, right))
    return itemsize * (psi + omega)


def dense_stream(shape, left_rank: int, right_rank: int):
    """The slab stream: X read once, the DRM cores read, the sketch and the
    TT written; the two projections ``T = X R`` and ``U = L^T X`` over a
    2-D view of X, ``N (r + rho)`` multiply-adds."""
    d = len(shape)
    left = (left_rank,) * (d - 1)
    right = (right_rank,) * (d - 1)
    n = prod(shape)
    drm = drm_bytes(shape, left_rank) + drm_bytes(shape[::-1], right_rank)
    nbytes = (F32 * n + drm + sketch_bytes(shape, left, right)
              + tt_bytes(shape, left))
    return {"bytes": nbytes, "flops": 2 * n * (left_rank + right_rank)}


def sparse_stta(shape, nnz: int, index_bytes: int, value_bytes: int,
                left_rank: int, right_rank: int):
    """COO read once; Psi_k needs ``r_{k-1} r'_k`` and Omega_k ``r_k r'_k``
    multiply-adds a nonzero; the sketch and the TT written."""
    d = len(shape)
    left = trim_ranks(shape, (left_rank,) * (d - 1))
    right = (right_rank,) * (d - 1)
    r_in, r_out = (1,) + left, right + (1,)
    macs = nnz * (sum(a * b for a, b in zip(r_in, r_out))
                  + sum(a * b for a, b in zip(left, right)))
    nbytes = (nnz * (d * index_bytes + value_bytes)
              + sketch_bytes(shape, left, right) + tt_bytes(shape, left))
    return {"bytes": nbytes, "flops": 2 * macs}


def sparse_hmt(shape, nnz: int, index_bytes: int, value_bytes: int,
               rank: int):
    """COO read once; Psi_k needs ``r_{k-1} r_k`` multiply-adds a nonzero,
    the chain step after core k (k >= 1) ``r_{k-1} r_k``; a Householder QR
    of each (r_{k-1} n_k, r_k) core ``2 m n^2 - 2 n^3 / 3`` flops; the TT
    written."""
    d = len(shape)
    ranks = trim_ranks(shape, (rank,) * (d - 1))
    r = (1,) + ranks + (1,)
    psi = sum(r[k] * r[k + 1] for k in range(d))
    chain = sum(r[k] * r[k + 1] for k in range(1, d - 1))
    qr = sum(2 * (r[k] * int(shape[k])) * r[k + 1] ** 2
             - 2 * r[k + 1] ** 3 / 3 for k in range(d - 1))
    nbytes = nnz * (d * index_bytes + value_bytes) + tt_bytes(shape, ranks)
    return {"bytes": nbytes, "flops": 2 * nnz * (psi + chain) + qr}
