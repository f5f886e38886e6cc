"""CP (canonical polyadic) tensor format (counterpart of
``tt_sketch_tpu/formats/cp.py``).

Factors are a list of ``(n_i, rank)`` matrices on one device.  ``size`` is a
property, as in the JAX package (the reference lacks the decorator).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tt_sketch_torch.formats.base import Tensor
from tt_sketch_torch.utils import random_normal


class CPTensor(Tensor):
    def __init__(self, cores) -> None:
        self.cores = list(cores)
        self.rank = int(self.cores[0].shape[1])
        self.shape = tuple(int(C.shape[0]) for C in self.cores)

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.cores[0].dtype

    @property
    def size(self) -> int:
        return sum(int(np.prod(C.shape)) for C in self.cores)

    @property
    def T(self) -> CPTensor:
        return CPTensor(self.cores[::-1])

    def to_dense(self) -> torch.Tensor:
        # Khatri-Rao accumulation: keep the rank axis, sum at the end
        dense = self.cores[0]  # (n0, r)
        for C in self.cores[1:]:
            dense = torch.einsum("...j,ij->...ij", dense, C)
        return dense.sum(dim=-1)

    def to_tt(self):
        """Exact TT of rank ``rank`` (interior cores diagonal in the rank
        index)."""
        from tt_sketch_torch.formats.tensor_train import TensorTrain

        d = len(self.cores)
        r = self.rank
        cores = []
        for i, C in enumerate(self.cores):
            if i == 0:
                cores.append(C[None, :, :])
            elif i == d - 1:
                cores.append(C.T[:, :, None])
            else:
                diag = C.new_zeros((r, C.shape[0], r))
                idx = torch.arange(r, device=C.device)
                diag[idx, :, idx] = C.T
                cores.append(diag)
        return TensorTrain(cores)

    def gather(self, idx) -> torch.Tensor:
        """Entries at the (d, N) multi-indices ``idx``."""
        if not isinstance(idx, torch.Tensor):
            idx = torch.from_numpy(np.asarray(idx))
        idx = idx.to(self.device)
        res = self.cores[0][idx[0]]  # (N, r)
        for C, ids in zip(self.cores[1:], idx[1:]):
            res = res * C[ids]
        return res.sum(dim=1)

    def __getitem__(self, index: int) -> torch.Tensor:
        return self.cores[index]

    def __mul__(self, other: float) -> CPTensor:
        new_cores = list(self.cores)
        new_cores[0] = new_cores[0] * other
        return CPTensor(new_cores)

    def __repr__(self) -> str:
        return f"<CP tensor of shape {self.shape} and rank {self.rank}>"

    @classmethod
    def random(cls, shape: Tuple[int, ...], rank: int,
               seed: Optional[int] = None, dtype=None,
               device=None) -> CPTensor:
        """Gaussian factors scaled by ``1/sqrt(n)``: the JAX package's
        draws for equal seeds."""
        seeds = np.random.SeedSequence(seed).generate_state(len(shape))
        cores = []
        for n, s in zip(shape, seeds):
            C = random_normal((n, rank), seed=int(s), dtype=dtype,
                              device=device)
            cores.append(C / float(np.sqrt(n)))
        return cls(cores)
