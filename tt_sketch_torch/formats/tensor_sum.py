"""Lazy sum of tensors (counterpart of
``tt_sketch_tpu/formats/tensor_sum.py``).

The streaming format: a sketch distributes over the summands by
linearity, so a ``TensorSum`` is never materialized.  Unlike the JAX
package's, it has ``device`` and ``dtype``, which the dispatch's placement
check reads: summands on different devices or with different dtypes raise
there, as a tensor and its DRMs do.
"""
from __future__ import annotations

from typing import Iterable, List, Union

import torch

from tt_sketch_torch.formats.base import Tensor


class TensorSum(Tensor):
    def __init__(self, tensors: List[Tensor], shape=None) -> None:
        if shape is None:
            shape = tensors[0].shape
        self.shape = tuple(shape)
        self.tensors = list(tensors)

    def _common(self, attr: str):
        values = {getattr(t, attr) for t in self.tensors}
        if len(values) != 1:
            raise ValueError(
                f"the summands of {self!r} differ in {attr}: "
                f"{sorted(map(str, values))}"
            )
        return values.pop()

    @property
    def device(self) -> torch.device:
        return self._common("device")

    @property
    def dtype(self) -> torch.dtype:
        return self._common("dtype")

    @property
    def size(self) -> int:
        return sum(t.size for t in self.tensors)

    @property
    def num_summands(self) -> int:
        return len(self.tensors)

    @property
    def T(self) -> TensorSum:
        return TensorSum([X.T for X in self.tensors], shape=self.shape[::-1])

    def to_dense(self) -> torch.Tensor:
        s = self.tensors[0].to_dense()
        for X in self.tensors[1:]:
            s = s + X.to_dense()
        return s

    def __add__(self, other) -> TensorSum:
        if isinstance(other, TensorSum):
            return TensorSum(self.tensors + other.tensors)
        return TensorSum(self.tensors + [other])

    def __iadd__(self, other) -> TensorSum:
        if isinstance(other, TensorSum):
            self.tensors.extend(other.tensors)
        else:
            self.tensors.append(other)
        return self

    def __mul__(self, other: Union[float, Iterable[float]]) -> TensorSum:
        """Scalar multiply, or per-summand coefficients when iterable."""
        try:
            coeffs = list(other)  # type: ignore[arg-type]
        except TypeError:
            return TensorSum([X * other for X in self.tensors])
        if len(coeffs) != len(self.tensors):
            raise ValueError(
                f"Got {len(coeffs)} coefficients for "
                f"{len(self.tensors)} summands"
            )
        return TensorSum([X * c for X, c in zip(self.tensors, coeffs)])

    def dot(self, other, reverse: bool = False) -> float:
        return float(sum(X.dot(other, reverse) for X in self.tensors))

    def __repr__(self) -> str:
        return f"<Sum of {self.num_summands} tensors of shape {self.shape}>"
