"""Functional tensor-train core operations on lists of torch tensors.

Counterpart of ``tt_sketch_tpu/formats/tt_ops.py``: dense contraction,
partial contractions, left-orthogonalization, norms, TT-SVD rounding (with
a host-read eps rank, a masked device-resident rank and a fixed rank cap),
singular values of the unfoldings, direct-sum addition, TT-TT inner
products and entry gathers.  Where the JAX package calls its Jacobi SVD
(``kernels/accurate_linalg.svd``, a TPU workaround) the port calls
``torch.linalg.svd(full_matrices=False)``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tt_sketch_torch.utils import process_tt_rank

TensorList = List[torch.Tensor]


def _svd(mat: torch.Tensor):
    return torch.linalg.svd(mat, full_matrices=False)


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
    return float(tt_norm_device(cores))


def tt_norm_device(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """``tt_norm`` without the device→host sync: a 0-d tensor on the
    cores' device (``tt_sketch_tpu/formats/tt_ops.py:77-84``)."""
    return torch.linalg.norm(tt_orthogonalize(cores)[-1])


def _round_setup(cores, max_rank, orthogonalized):
    cores = list(cores if orthogonalized else tt_orthogonalize(cores))
    shape = tuple(int(C.shape[1]) for C in cores)
    if max_rank is None:
        max_rank = tuple(int(C.shape[0]) for C in cores[1:])
    return cores, process_tt_rank(max_rank, shape, trim=True)


def _rl_truncate(cores: TensorList, truncate) -> TensorList:
    """The right-to-left SVD sweep of the roundings: core μ absorbs the
    step before's ``U·S``; for μ > 0 the SVD of its ``(r, n·r')`` unfolding
    goes to ``truncate(U, S, Vt, mu)``, which returns the ``U·S`` to pass
    on and the rows of ``Vᵀ`` that become core μ."""
    new_cores: TensorList = []
    US: Optional[torch.Tensor] = None
    for mu in range(len(cores) - 1, -1, -1):
        C = cores[mu]
        if US is not None:
            C = torch.einsum("ijk,kl->ijl", C, US)
        if mu > 0:
            U, S, Vt = _svd(C.reshape(C.shape[0], C.shape[1] * C.shape[2]))
            US, Vt = truncate(U, S, Vt, mu)
            C = Vt.reshape(Vt.shape[0], C.shape[1], C.shape[2])
        new_cores.append(C)
    return new_cores[::-1]


def tt_round(
    cores: Sequence[torch.Tensor],
    eps: Optional[float] = None,
    max_rank=None,
    orthogonalized: bool = False,
) -> TensorList:
    """TT-SVD rounding: LR orthogonalize, then RL SVD-truncate sweep
    (``tt_sketch_tpu/formats/tt_ops.py:87-125``).

    Leaves the TT right-orthogonalized; mode μ keeps
    ``max(1, min(#{S > S[0]·eps}, max_rank[μ-1]))`` singular values.  The
    eps rank is read on the host: one copy of ``S`` per mode.
    """
    cores, max_rank = _round_setup(cores, max_rank, orthogonalized)
    eps = 0.0 if eps is None else eps

    def truncate(U, S, Vt, mu):
        S_host = S.cpu().numpy()
        thresh = int(np.sum(S_host > S_host[0] * eps))
        r = max(1, min(thresh, max_rank[mu - 1]))
        return U[:, :r] * S[:r][None, :], Vt[:r, :]

    return _rl_truncate(cores, truncate)


def tt_round_masked(
    cores: Sequence[torch.Tensor],
    eps=None,
    max_rank=None,
    orthogonalized: bool = False,
) -> Tuple[TensorList, torch.Tensor]:
    """Device-resident eps-rounding with static shapes
    (``tt_sketch_tpu/formats/tt_ops.py:128-186``).

    The truncation rule of :func:`tt_round`, with the rank choice kept on
    the device: core μ keeps the static rank ``r_s = min(rows, cols,
    max_rank[μ-1])`` and the entries past ``k = clip(#{S > S[0]·eps}, 1,
    r_s)`` are exact zeros, so the represented tensor is the sliced one's.
    ``eps`` may be a 0-d tensor.  Returns ``(new_cores, eff_ranks)``,
    ``eff_ranks`` a device int32 tensor of the ``d-1`` eps ranks; slicing
    with :func:`tt_slice_to_ranks` afterwards is exact.
    """
    cores, max_rank = _round_setup(cores, max_rank, orthogonalized)
    eps = 0.0 if eps is None else eps
    eff_ranks: TensorList = []

    def truncate(U, S, Vt, mu):
        r_s = min(int(U.shape[0]), int(Vt.shape[1]), int(max_rank[mu - 1]))
        k = torch.clamp(torch.sum(S > S[0] * eps), 1, r_s).to(torch.int32)
        mask = (torch.arange(r_s, device=S.device) < k).to(U.dtype)
        eff_ranks.append(k)
        return (U[:, :r_s] * (S[:r_s] * mask)[None, :],
                Vt[:r_s, :] * mask[:, None])

    new_cores = _rl_truncate(cores, truncate)
    eff = (torch.stack(eff_ranks[::-1]) if eff_ranks
           else torch.zeros((0,), dtype=torch.int32, device=cores[0].device))
    return new_cores, eff


def tt_slice_to_ranks(cores: Sequence[torch.Tensor], ranks) -> TensorList:
    """Slice each core to ``[:r[μ-1], :, :r[μ]]`` (ranks read on the host).

    Exact for the output of :func:`tt_round_masked`: the discarded row
    slices are zero, and discarded column slices only ever multiply
    discarded (zero) row slices of the next core."""
    if isinstance(ranks, torch.Tensor):
        ranks = ranks.tolist()
    full = [1] + [int(r) for r in np.asarray(ranks)] + [1]
    return [C[: full[i], :, : full[i + 1]] for i, C in enumerate(cores)]


def tt_round_fixed_rank(
    cores: Sequence[torch.Tensor], max_rank, orthogonalized: bool = False
) -> TensorList:
    """Rounding to a fixed rank cap with no eps cut and no host read
    (``tt_sketch_tpu/formats/tt_ops.py:202-226``): mode μ keeps
    ``min(rows, cols, max_rank[μ-1])`` singular values."""
    cores, max_rank = _round_setup(cores, max_rank, orthogonalized)

    def truncate(U, S, Vt, mu):
        r = min(int(U.shape[0]), int(Vt.shape[1]), max_rank[mu - 1])
        return U[:, :r] * S[:r][None, :], Vt[:r, :]

    return _rl_truncate(cores, truncate)


def tt_svdvals(cores: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Singular values of the unfoldings, one numpy array per core as the
    JAX package returns them (``tt_sketch_tpu/formats/tt_ops.py:229-245``;
    the first two both belong to the unfolding between modes 0 and 1)."""
    cores = tt_orthogonalize(cores)
    out: List[np.ndarray] = []
    US: Optional[torch.Tensor] = None
    for mu in range(len(cores) - 1, -1, -1):
        C = cores[mu]
        if US is not None:
            C = torch.einsum("ijk,kl->ijl", C, US)
        if mu > 0:
            mat = C.reshape(C.shape[0], C.shape[1] * C.shape[2])
        else:
            mat = C.reshape(C.shape[0] * C.shape[1], C.shape[2])
        U, S, _ = _svd(mat)
        US = U * S[None, :]
        out.append(S.cpu().numpy())
    return out[::-1]


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
