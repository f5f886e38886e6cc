"""Deterministic TT-SVD (counterpart of ``tt_sketch_tpu/solvers/tt_svd.py``).

Left-to-right sweep of truncated SVDs of the successive unfoldings, with
``torch.linalg.svd`` where the JAX package calls its Jacobi SVD.  The
ranks are the requested caps (trimmed), so no singular value is read on
the host.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from tt_sketch_torch.formats.base import Tensor
from tt_sketch_torch.formats.tensor_train import TensorTrain
from tt_sketch_torch.utils import TTRank, matricize, process_tt_rank


def tt_svd(tensor: Union[Tensor, torch.Tensor],
           rank: Optional[TTRank] = None) -> TensorTrain:
    """The TT-SVD of (the dense form of) ``tensor``, a ``Tensor`` or a
    torch tensor, on the device it lies on
    (``tt_sketch_tpu/solvers/tt_svd.py:20-47``)."""
    X = tensor.to_dense() if isinstance(tensor, Tensor) else tensor
    if not isinstance(X, torch.Tensor):
        raise TypeError(
            f"tt_svd takes a Tensor or a torch.Tensor, got {type(X).__name__}"
        )
    shape = tuple(int(s) for s in X.shape)
    d = len(shape)
    if rank is None:
        rank = (int(np.prod(shape)),) * (d - 1)
    new_rank = list(process_tt_rank(rank, shape, trim=True))
    cores = []
    compressed = X
    for mu in range(d - 1):
        mat = (matricize(X, 0) if mu == 0
               else matricize(compressed, (0, 1), mat_shape=True))
        U, S, V = torch.linalg.svd(mat, full_matrices=False)
        r = max(min(int(U.shape[1]), new_rank[mu]), 1)
        new_rank[mu] = r
        r_prev = 1 if mu == 0 else new_rank[mu - 1]
        cores.append(U[:, :r].reshape(r_prev, shape[mu], r))
        compressed = (S[:r, None] * V[:r, :]).reshape((r,) + shape[mu + 1:])
    cores.append(compressed.reshape(new_rank[d - 2], shape[d - 1], 1))
    return TensorTrain(cores)
