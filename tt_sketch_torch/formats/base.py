"""Abstract tensor base: shared algebra (error, dot, norm, scalar ops).

Counterpart of ``tt_sketch_tpu/formats/base.py``.  ``+`` between tensors
builds a lazy ``TensorSum`` (``formats/tensor_sum.py``).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Tuple, TypeVar

import numpy as np
import torch

TType = TypeVar("TType", bound="Tensor")


class Tensor(ABC):
    """Abstract base class for all tensor formats."""

    shape: Tuple[int, ...]

    @property
    @abstractmethod
    def T(self: TType) -> TType:
        """Mode-reversed tensor: shape ``(n_d, ..., n_1)``."""

    @property
    @abstractmethod
    def size(self) -> int:
        """Number of floats used to store the tensor."""

    @abstractmethod
    def to_dense(self) -> torch.Tensor:
        """Contract to a dense torch tensor of the same shape."""

    @property
    def ndim(self) -> int:
        return len(self.shape)

    # -- algebra ------------------------------------------------------------

    def error(
        self,
        other,
        relative: bool = False,
        rmse: bool = False,
        fast: bool = False,
    ) -> float:
        """L2 error vs ``other`` (a ``Tensor``, torch tensor or numpy array).

        ``fast=True`` uses the inner-product identity
        ``|x-y|^2 = |x|^2 + |y|^2 - 2<x,y>`` (cheap for structured formats but
        inaccurate below ~1e-8 relative error).
        """
        from tt_sketch_torch.formats.dense import DenseTensor

        mine = self.to_dense()
        if isinstance(other, np.ndarray):
            other = torch.from_numpy(other).to(mine.device)
        if isinstance(other, torch.Tensor):
            other = DenseTensor(other)
        other_norm = other.norm()
        if fast:
            self_norm = self.norm()
            dot = self.dot(other)
            norm_sum = self_norm ** 2 + other_norm ** 2
            err = float(
                np.sqrt(norm_sum) * np.sqrt(np.abs(1 - 2 * dot / norm_sum))
            )
        else:
            err = float(torch.linalg.norm(mine - other.to_dense()))
        if relative:
            if other_norm == 0:
                return float(np.inf)
            err /= other_norm
        if rmse:
            err /= float(np.sqrt(np.prod(self.shape)))
        return err

    def dot(self, other, reverse: bool = False) -> float:
        """Inner product with double dispatch: give ``other`` a first shot."""
        from tt_sketch_torch.formats.tensor_sum import TensorSum

        if isinstance(other, TensorSum):
            return other.dot(self)
        if not reverse:
            return other.dot(self, reverse=True)
        a = self.to_dense().reshape(-1)
        b = other.to_dense().reshape(-1)
        return float(torch.dot(a, b))

    def norm(self) -> float:
        return float(np.sqrt(np.abs(self.dot(self))))

    def __matmul__(self, other) -> float:
        return self.dot(other)

    # -- lazy sum / scalar ops ----------------------------------------------

    def __add__(self, other):
        from tt_sketch_torch.formats.tensor_sum import TensorSum

        if isinstance(other, TensorSum):
            if isinstance(self, TensorSum):
                return TensorSum(self.tensors + other.tensors)
            return TensorSum([self] + other.tensors)
        if isinstance(self, TensorSum):
            return TensorSum(self.tensors + [other])
        return TensorSum([self, other])

    @abstractmethod
    def __mul__(self: TType, other: float) -> TType:
        ...

    def __rmul__(self: TType, other: float) -> TType:
        return self.__mul__(other)

    def __truediv__(self, other: float):
        return self.__mul__(1.0 / other)

    def __sub__(self, other):
        return self + (-other)

    def __neg__(self):
        return self * -1.0
