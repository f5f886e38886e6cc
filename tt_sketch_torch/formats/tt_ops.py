"""Functional tensor-train core operations on lists of torch tensors.

Counterpart of ``tt_sketch_tpu/formats/tt_ops.py`` for what this slice
needs: dense contraction, partial contractions, left-orthogonalization,
norm, direct-sum addition, TT-TT inner products and entry gathers.
Rounding and singular values come with a later slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

TensorList = List[torch.Tensor]


def tt_to_dense(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Contract TT cores to the dense tensor."""
    dense = cores[0].reshape(cores[0].shape[1:])
    for C in cores[1:]:
        dense = torch.einsum("...j,jkl->...kl", dense, C)
    return dense.reshape(dense.shape[:-1])


def tt_partial_dense(cores: Sequence[torch.Tensor],
                     dir: str = "lr") -> TensorList:
    """Partial prefix (``lr``) or suffix (``rl``) contraction matrices.

    ``lr``: entry μ has shape ``(n_1⋯n_{μ+1}, r_{μ+1})`` for μ=0..d-2.
    """
    if dir == "lr":
        parts = [cores[0].reshape(-1, cores[0].shape[-1])]
        for C in cores[1:-1]:
            nxt = torch.einsum("ij,jkl->ikl", parts[-1], C)
            parts.append(nxt.reshape(-1, nxt.shape[-1]))
    elif dir == "rl":
        parts = [cores[-1].reshape(cores[-1].shape[0], -1)]
        for C in cores[-2:0:-1]:
            nxt = torch.einsum("ijk,kl->ijl", C, parts[-1])
            parts.append(nxt.reshape(nxt.shape[0], -1))
    else:
        raise ValueError(f"Unknown direction {dir}")
    return parts


def tt_orthogonalize(cores: Sequence[torch.Tensor]) -> TensorList:
    """Left-orthogonalize with an LR QR sweep."""
    new_cores: TensorList = []
    R: Optional[torch.Tensor] = None
    d = len(cores)
    for mu, C in enumerate(cores):
        if mu > 0:
            C = torch.einsum("ij,jkl->ikl", R, C)
        if mu < d - 1:
            mat = C.reshape(C.shape[0] * C.shape[1], C.shape[2])
            Q, R = torch.linalg.qr(mat)
            new_cores.append(Q.reshape(C.shape[0], C.shape[1], -1))
        else:
            new_cores.append(C)
    return new_cores


def tt_norm(cores: Sequence[torch.Tensor]) -> float:
    return float(torch.linalg.norm(tt_orthogonalize(cores)[-1]))


def tt_add(
    cores1: Sequence[torch.Tensor], cores2: Sequence[torch.Tensor]
) -> TensorList:
    """Direct-sum addition of two TTs (block-diagonal interior cores)."""
    new_cores = [torch.cat((cores1[0], cores2[0]), dim=2)]
    for C1, C2 in zip(cores1[1:-1], cores2[1:-1]):
        r1, n, r2 = C1.shape
        r3, _, r4 = C2.shape
        row1 = torch.cat((C1, C1.new_zeros((r1, n, r4))), dim=2)
        row2 = torch.cat((C2.new_zeros((r3, n, r2)), C2), dim=2)
        new_cores.append(torch.cat((row1, row2), dim=0))
    new_cores.append(torch.cat((cores1[-1], cores2[-1]), dim=0))
    return new_cores


def tt_dot(
    cores1: Sequence[torch.Tensor], cores2: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Inner product of two TTs via an LR sweep (O(d n r^3))."""
    result = torch.einsum("ijk,ljm->km", cores1[0], cores2[0])
    for C1, C2 in zip(cores1[1:], cores2[1:]):
        result = torch.einsum("ij,ika->jka", result, C1)
        result = torch.einsum("jka,jkb->ab", result, C2)
    return torch.sum(result)


def tt_gather(cores: Sequence[torch.Tensor], idx) -> torch.Tensor:
    """Entries at the (d, N) multi-indices ``idx``: one core-slice gather
    and batched contraction per mode."""
    result = cores[0][0, idx[0], :]  # (N, r1)
    for i in range(1, len(cores)):
        sl = cores[i][:, idx[i], :]  # (r1, N, r2)
        result = torch.einsum("nr,rns->ns", result, sl)
    return result.reshape(-1)
