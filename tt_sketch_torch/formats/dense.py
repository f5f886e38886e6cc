"""Dense tensor format (counterpart of ``tt_sketch_tpu/formats/dense.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tt_sketch_torch.formats.base import Tensor
from tt_sketch_torch.utils import random_normal


class DenseTensor(Tensor):
    """A plain dense torch tensor; it stays on the device it lies on."""

    def __init__(self, data: torch.Tensor) -> None:
        if not isinstance(data, torch.Tensor):
            raise TypeError(
                f"DenseTensor takes a torch.Tensor, got {type(data).__name__}"
            )
        self.data = data
        self.shape = tuple(int(s) for s in data.shape)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def T(self) -> DenseTensor:
        perm = tuple(range(len(self.shape))[::-1])
        return DenseTensor(self.data.permute(perm))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def to_dense(self) -> torch.Tensor:
        return self.data

    def to_sparse(self):
        """COO view of all entries, row-major, with int64 indices on the
        tensor's device (``tt_sketch_tpu/formats/dense.py:41-46``)."""
        from tt_sketch_torch.formats.sparse import SparseTensor

        grids = torch.meshgrid(
            *[torch.arange(n, device=self.device) for n in self.shape],
            indexing="ij",
        )
        inds = torch.stack(grids).reshape(len(self.shape), -1)
        return SparseTensor(self.shape, inds, self.data.reshape(-1))

    def __mul__(self, other: float) -> DenseTensor:
        return DenseTensor(self.data * other)

    def __repr__(self) -> str:
        return f"<Dense tensor of shape {self.shape}>"

    @classmethod
    def random(
        cls, shape: Tuple[int, ...], seed: Optional[int] = None, dtype=None,
        device=None,
    ) -> DenseTensor:
        return cls(random_normal(shape, seed=seed, dtype=dtype, device=device))
