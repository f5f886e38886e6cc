"""Tucker tensor format (counterpart of
``tt_sketch_tpu/formats/tucker.py``).

A core of shape ``(s_1, ..., s_d)`` and factor matrices ``(s_i, n_i)``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from tt_sketch_torch.formats.base import Tensor
from tt_sketch_torch.utils import random_normal


class TuckerTensor(Tensor):
    def __init__(self, factors, core) -> None:
        self.core = core
        self.factors = list(factors)
        self.shape = tuple(int(U.shape[1]) for U in self.factors)
        self.rank = tuple(int(U.shape[0]) for U in self.factors)

    @property
    def device(self) -> torch.device:
        return self.core.device

    @property
    def dtype(self) -> torch.dtype:
        return self.core.dtype

    @property
    def T(self) -> TuckerTensor:
        perm = tuple(range(len(self.shape))[::-1])
        return TuckerTensor(self.factors[::-1], self.core.permute(perm))

    @property
    def size(self) -> int:
        return int(np.prod(self.core.shape)) + sum(
            int(np.prod(U.shape)) for U in self.factors
        )

    def to_dense(self) -> torch.Tensor:
        out = self.core
        for i, U in enumerate(self.factors):
            left = int(np.prod(self.shape[:i], dtype=np.int64))
            right = int(np.prod(self.rank[i + 1:], dtype=np.int64))
            out = out.reshape(left, self.rank[i], right)
            out = torch.einsum("ijk,jl->ilk", out, U)
        return out.reshape(self.shape)

    def __mul__(self, other: float) -> TuckerTensor:
        return TuckerTensor(self.factors, self.core * other)

    def __repr__(self) -> str:
        return f"<Tucker tensor of shape {self.shape} and rank {self.rank}>"

    @classmethod
    def random(cls, shape: Tuple[int, ...],
               rank: Union[int, Tuple[int, ...]],
               seed: Optional[int] = None, dtype=None,
               device=None) -> TuckerTensor:
        """Gaussian core and QR-orthonormal row factors, from the JAX
        package's draws for equal seeds (the QR's column signs follow the
        device's LAPACK)."""
        d = len(shape)
        try:
            rank_tuple = tuple(rank)  # type: ignore[arg-type]
        except TypeError:
            rank_tuple = (rank,) * d  # type: ignore[assignment]
        rank_tuple = tuple(min(r, n) for r, n in zip(rank_tuple, shape))

        seq = np.random.SeedSequence(seed)
        core_seed = int(seq.generate_state(1)[0])
        core = random_normal(rank_tuple, seed=core_seed, dtype=dtype,
                             device=device)
        factors = []
        for r, n, s in zip(rank_tuple, shape, seq.generate_state(d)):
            U = random_normal((r, n), seed=int(s), dtype=dtype,
                              device=device)
            factors.append(torch.linalg.qr(U.T)[0].T)
        return cls(factors, core)
