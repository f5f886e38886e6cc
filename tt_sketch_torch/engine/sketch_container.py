"""SketchContainer: the linear accumulator state ``(Ψ_cores, Ω_mats)``.

Counterpart of ``tt_sketch_tpu/engine/sketch_container.py``.  Sketches of
summands or dense slabs combine by plain addition (linearity of the sketch
map); scaling every Ψ and Ω by ``c`` scales the reconstruction by ``c``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from tt_sketch_torch.config import DEFAULT_DTYPE, resolve_device


class SketchContainer:
    Psi_cores: List[torch.Tensor]
    Omega_mats: List[torch.Tensor]

    def __init__(
        self,
        Psi_cores,
        Omega_mats,
        shape: Optional[Tuple[int, ...]] = None,
        left_rank: Optional[Tuple[int, ...]] = None,
        right_rank: Optional[Tuple[int, ...]] = None,
    ) -> None:
        self.Psi_cores = list(Psi_cores)
        self.Omega_mats = list(Omega_mats)
        if shape is None:
            shape = tuple(int(P.shape[1]) for P in self.Psi_cores)
        if left_rank is None:
            left_rank = tuple(int(P.shape[0]) for P in self.Psi_cores[1:])
        if right_rank is None:
            right_rank = tuple(int(P.shape[2]) for P in self.Psi_cores[:-1])
        self.shape = tuple(shape)
        self.left_rank = tuple(left_rank)
        self.right_rank = tuple(right_rank)

    @classmethod
    def zero(
        cls,
        shape: Tuple[int, ...],
        left_rank: Tuple[int, ...],
        right_rank: Tuple[int, ...],
        dtype=None,
        device=None,
    ) -> "SketchContainer":
        dtype = dtype or DEFAULT_DTYPE
        device = resolve_device(device)
        Psi_cores = [
            torch.zeros((r1, n, r2), dtype=dtype, device=device)
            for r1, n, r2 in zip(
                (1,) + tuple(left_rank), shape, tuple(right_rank) + (1,)
            )
        ]
        Omega_mats = [
            torch.zeros((r1, r2), dtype=dtype, device=device)
            for r1, r2 in zip(left_rank, right_rank)
        ]
        return cls(Psi_cores, Omega_mats, shape, left_rank, right_rank)

    def __add__(self, other: "SketchContainer") -> "SketchContainer":
        return SketchContainer(
            [P1 + P2 for P1, P2 in zip(self.Psi_cores, other.Psi_cores)],
            [O1 + O2 for O1, O2 in zip(self.Omega_mats, other.Omega_mats)],
        )

    @property
    def T(self) -> "SketchContainer":
        return SketchContainer(
            [P.permute(2, 1, 0) for P in self.Psi_cores[::-1]],
            [O.T for O in self.Omega_mats[::-1]],
        )

    def __mul__(self, other: float) -> "SketchContainer":
        return SketchContainer(
            [P * other for P in self.Psi_cores],
            [O * other for O in self.Omega_mats],
        )

    __rmul__ = __mul__

    def __neg__(self) -> "SketchContainer":
        return self * -1.0

    def __sub__(self, other: "SketchContainer") -> "SketchContainer":
        return self + (-other)

    def __truediv__(self, other: float) -> "SketchContainer":
        return self * (1.0 / other)
