"""Plain reference of the sparse sketches: STTA (``stream_sketch`` then
``to_tt``) and HMT (``hmt_sketch``) of a COO tensor with hashed DRMs.

Straight from the definitions, over blocks of nonzeros ``j`` with entries
``e_j``, left rows ``L_k`` (generator step ``k`` of the left DRM at the
prefix ``0..k``) and right rows ``R_k`` (step ``d-2-k`` of the right DRM at
the reversed suffix ``k+1..d-1``):

    Psi_k[a, i, b] = sum_{j: idx_k(j) = i} L_{k-1}[a, j] e_j R_k[b, j]
    Omega_k[a, b]  = sum_j L_k[a, j] e_j R_k[b, j]

STTA recovers ``C_k = Psi_k pinv(Omega_k)``.  HMT has no left DRM: its left
rows are the chain of the QR-orthogonalized cores so far,
``L_k[b, j] = sum_a L_{k-1}[a, j] Q_k[a, idx_k(j), b]``.

``precision``: ``float64`` (the reference) or ``bfloat16`` (the control:
rows and entries rounded to bfloat16, sums in float32).  Imports only
torch.
"""
from __future__ import annotations

from functools import reduce
from operator import mul
from typing import Sequence, Tuple

import torch

from ttbench.reference import hashrows
from ttbench.reference.dense_stream import right_pinv
from ttbench.reference.lowp import compute_dtype, lower

BLOCK = 1 << 18


def trim_ranks(dims: Sequence[int], ranks: Sequence[int]) -> Tuple[int, ...]:
    """The largest TT ranks a tensor of ``dims`` can have, at most
    ``ranks``."""
    out = [min(r, reduce(mul, dims[: i + 1], 1), reduce(mul, dims[i + 1:], 1))
           for i, r in enumerate(ranks)]
    out = [1] + out + [1]
    for _ in range(100):
        changed = False
        for i, d in enumerate(dims):
            if out[i + 1] > out[i] * d:
                out[i + 1], changed = out[i] * d, True
            if out[i] > d * out[i + 1]:
                out[i], changed = d * out[i + 1], True
        if not changed:
            break
    return tuple(out[1:-1])


def _left_rows(kind, idx, shape, k, rank, seed, precision):
    flat = hashrows.flat_prefix(idx[: k + 1], shape[: k + 1])
    return lower(hashrows.rows(kind, flat, rank,
                               hashrows.step_seed(seed, k)), precision)


def _right_rows(kind, idx, shape, k, rank, seed, precision):
    """Rows of the right side of core ``k``: the right DRM's step
    ``d-2-k`` over the reversed modes ``d-1..k+1``."""
    d = len(shape)
    step = d - 2 - k
    flat = hashrows.flat_prefix(idx.flip(0)[: step + 1],
                                tuple(shape)[::-1][: step + 1])
    return lower(hashrows.rows(kind, flat, rank,
                               hashrows.step_seed(seed, step)), precision)


def _scatter(psi, idx_k, left, e, right):
    """Add the block's outer products into ``psi`` (n, r1 * r2)."""
    lw = e[None, :] if left is None else left * e[None, :]
    r = torch.ones_like(e)[None, :] if right is None else right
    outer = (lw.T[:, :, None] * r.T[:, None, :]).reshape(e.shape[0], -1)
    psi.index_add_(0, idx_k, outer)


def stta(indices, entries, shape, left_rank, right_rank, seed: int,
         left_kind: str, right_kind: str, precision: str = "float64"):
    """Psi cores, Omega matrices and recovered cores of ``stream_sketch(...,
    seed=seed).to_tt()`` with uniform ``left_rank < right_rank``."""
    d = len(shape)
    shape = tuple(int(n) for n in shape)
    lr = trim_ranks(shape, (left_rank,) * (d - 1))
    rr = (right_rank,) * (d - 1)
    rseed = hashrows.right_seed(seed, d)
    dt = compute_dtype(precision)
    dev = entries.device
    r_in = (1,) + lr
    r_out = rr + (1,)
    psis = [torch.zeros((shape[k], r_in[k] * r_out[k]), dtype=dt, device=dev)
            for k in range(d)]
    omegas = [torch.zeros((lr[k], rr[k]), dtype=dt, device=dev)
              for k in range(d - 1)]
    for j0 in range(0, entries.shape[0], BLOCK):
        idx = indices[:, j0:j0 + BLOCK]
        e = lower(entries[j0:j0 + BLOCK], precision)
        left = [_left_rows(left_kind, idx, shape, k, lr[k], seed, precision)
                for k in range(d - 1)]
        right = [_right_rows(right_kind, idx, shape, k, rr[k], rseed,
                             precision) for k in range(d - 1)]
        for k in range(d):
            _scatter(psis[k], idx[k], left[k - 1] if k > 0 else None, e,
                     right[k] if k < d - 1 else None)
        for k in range(d - 1):
            omegas[k] += (left[k] * e[None, :]) @ right[k].T
    psis = [p.reshape(shape[k], r_in[k], r_out[k]).permute(1, 0, 2)
            for k, p in enumerate(psis)]
    cores = [right_pinv(p, o, precision) for p, o in zip(psis[:-1], omegas)]
    return psis, omegas, cores + [psis[-1]]


def hmt(indices, entries, shape, rank, seed: int, kind: str,
        precision: str = "float64"):
    """Cores of ``hmt_sketch(..., rank, seed=seed)`` with a hashed DRM of
    ``kind``: each Psi_k QR-orthogonalized but the last."""
    d = len(shape)
    shape = tuple(int(n) for n in shape)
    rr = trim_ranks(shape, (rank,) * (d - 1))
    dt = compute_dtype(precision)
    dev = entries.device
    nnz = entries.shape[0]
    chain = None  # (r, nnz) left rows of the orthogonalized cores so far
    cores = []
    for k in range(d):
        r1 = 1 if chain is None else chain.shape[0]
        r2 = rr[k] if k < d - 1 else 1
        psi = torch.zeros((shape[k], r1 * r2), dtype=dt, device=dev)
        for j0 in range(0, nnz, BLOCK):
            idx = indices[:, j0:j0 + BLOCK]
            e = lower(entries[j0:j0 + BLOCK], precision)
            right = (_right_rows(kind, idx, shape, k, r2, seed, precision)
                     if k < d - 1 else None)
            left = None if chain is None else chain[:, j0:j0 + BLOCK]
            _scatter(psi, idx[k], left, e, right)
        psi = psi.reshape(shape[k], r1, r2).permute(1, 0, 2)
        if k == d - 1:
            cores.append(psi)
            break
        q, _ = torch.linalg.qr(psi.reshape(r1 * shape[k], r2))
        q = lower(q, precision).reshape(r1, shape[k], -1)
        cores.append(q)
        new = torch.empty((q.shape[2], nnz), dtype=dt, device=dev)
        for j0 in range(0, nnz, BLOCK):
            g = q[:, indices[k, j0:j0 + BLOCK], :]  # (r1, block, r2)
            new[:, j0:j0 + BLOCK] = (
                g[0].T if chain is None
                else torch.einsum("aj,ajb->bj", chain[:, j0:j0 + BLOCK], g))
        chain = lower(new, precision)
    return cores
