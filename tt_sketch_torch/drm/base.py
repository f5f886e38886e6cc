"""DRM (dimension-reduction matrix) base classes and capability protocol.

Counterpart of ``tt_sketch_tpu/drm/base.py``: rank-slice bookkeeping
(``rank_min``/``rank_max``/``true_rank``), transpose semantics (a right DRM
is a left DRM of the reversed tensor), the ``CanSlice`` /
``CanIncreaseRank`` capabilities, the lazy per-mode ``LazyModeList`` and the
``handle_transpose`` wrapper.
The JAX pytree registration has no counterpart: a DRM is a plain object.
"""
from __future__ import annotations

import copy
from abc import ABC, abstractmethod
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tt_sketch_torch.config import DEFAULT_DTYPE, resolve_device
from tt_sketch_torch.utils import TTRank, process_tt_rank


class DRM(ABC):
    rank: Tuple[int, ...]       # size of the (possibly sliced) rank block
    rank_min: Tuple[int, ...]   # start of rank slice (blocked sketch)
    rank_max: Tuple[int, ...]   # end of rank slice
    true_rank: Tuple[int, ...]  # full rank before slicing
    shape: Tuple[int, ...]
    transpose: bool             # False: left sketch; True: right sketch
    seed: int
    device: torch.device

    def __init__(
        self,
        rank: TTRank,
        shape: Tuple[int, ...],
        transpose: bool,
        seed: Optional[int] = None,
        rank_min: Optional[Tuple[int, ...]] = None,
        rank_max: Optional[Tuple[int, ...]] = None,
        true_rank: Optional[Tuple[int, ...]] = None,
        dtype=None,
        device=None,
        **kwargs,
    ) -> None:
        self.transpose = transpose
        self.dtype = dtype or DEFAULT_DTYPE
        self.device = resolve_device(device)
        rank = process_tt_rank(rank, shape, trim=False)
        self.true_rank = tuple(true_rank) if true_rank is not None else rank
        self.rank_min = (
            tuple(rank_min) if rank_min is not None else (0,) * (len(shape) - 1)
        )
        self.rank_max = tuple(rank_max) if rank_max is not None else rank

        if transpose:
            self.true_rank = self.true_rank[::-1]
            self.rank_min = self.rank_min[::-1]
            self.rank_max = self.rank_max[::-1]
        self.rank = tuple(
            r2 - r1 for r1, r2 in zip(self.rank_min, self.rank_max)
        )

        self.shape = tuple(shape)
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2 ** 31))
        self.seed = int(seed % (2 ** 32 - 1))

    @property
    def T(self) -> "DRM":
        transposed = copy.copy(self)
        transposed.transpose = not self.transpose
        transposed.true_rank = self.true_rank[::-1]
        transposed.rank_min = self.rank_min[::-1]
        transposed.rank_max = self.rank_max[::-1]
        transposed.rank = self.rank[::-1]
        return transposed

    def __repr__(self) -> str:
        direction = "Right" if self.transpose else "Left"
        return (
            f"<{direction} {self.__class__.__name__} of rank {self.rank}"
            f" and shape {self.shape}>"
        )


class CanSlice(DRM):
    """The DRM can produce an arbitrary rank-block of itself exactly
    (required by blocked sketches and ``increase_rank``)."""

    def slice(
        self, start_rank: Tuple[int, ...], end_rank: Tuple[int, ...]
    ) -> DRM:
        new_true_rank = self.true_rank[::-1] if self.transpose else self.true_rank
        return self.__class__(
            rank=self.rank,
            shape=self.shape,
            transpose=self.transpose,
            seed=self.seed,
            rank_min=tuple(start_rank),
            rank_max=tuple(end_rank),
            true_rank=new_true_rank,
            dtype=self.dtype,
            device=self.device,
        )


class CanIncreaseRank(CanSlice):
    """The DRM is prefix-stable under rank growth: the rank-``r`` DRM is the
    leading block of the rank-``R`` DRM for ``r < R``."""

    def increase_rank(self, new_rank: Tuple[int, ...]) -> DRM:
        return self.__class__(
            new_rank, self.shape, self.transpose, self.seed, dtype=self.dtype,
            device=self.device,
        )


class LazyModeList:
    """A per-mode contraction list that computes mode ``k`` on first access
    (cached).

    Hash-family DRMs return this from ``sketch_sparse``: the fused sparse
    kernels hash the rows they need themselves, so modes that no consumer
    reads are never generated."""

    def __init__(self, fn: Callable, n: int, reverse: bool = False) -> None:
        self._fn = fn
        self._n = n
        self._rev = reverse
        self._cache: dict = {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int):
        if not (-self._n <= i < self._n):
            raise IndexError(i)
        i %= self._n
        j = self._n - 1 - i if self._rev else i
        if j not in self._cache:
            self._cache[j] = self._fn(j)
        return self._cache[j]

    def __iter__(self):
        return (self[i] for i in range(self._n))

    def reversed(self) -> "LazyModeList":
        out = LazyModeList(self._fn, self._n, reverse=not self._rev)
        out._cache = self._cache  # the same underlying modes
        return out


def handle_transpose(sketch: Callable) -> Callable:
    """Right-sketches are left-sketches of the reversed tensor: transpose the
    input and reverse the output list (a ``LazyModeList`` is reversed
    lazily)."""

    def wrapper(self, tensor) -> List[torch.Tensor]:
        if self.shape != tensor.shape:
            raise ValueError(
                f"Shape {self.shape} of DRM doesn't match tensor's shape "
                f"{tensor.shape}"
            )
        if self.transpose:
            tensor = tensor.T
        out = sketch(self, tensor)
        if isinstance(out, LazyModeList):
            return out.reversed() if self.transpose else out
        mats = list(out)
        if self.transpose:
            mats = mats[::-1]
        return mats

    return wrapper


# Capability protocols: which formats a DRM can sketch.

class CansketchSparse(DRM, ABC):
    @abstractmethod
    def sketch_sparse(self, tensor) -> List[torch.Tensor]:
        """Per-mode ``(rank[mu], nnz)`` row-samples of the DRM at the
        tensor's nnz prefix indices."""


class CansketchDense(DRM, ABC):
    @abstractmethod
    def sketch_dense(self, tensor) -> List[torch.Tensor]:
        """Per-mode dense DRM matrices of shape ``(rank[mu], prod(shape[:mu+1]))``."""


class CansketchTT(DRM, ABC):
    @abstractmethod
    def sketch_tt(self, tensor) -> List[torch.Tensor]:
        """Per-mode ``(tensor.rank[mu], rank[mu])`` partial contractions."""


class CansketchCP(DRM, ABC):
    @abstractmethod
    def sketch_cp(self, tensor) -> List[torch.Tensor]:
        """Per-mode ``(cp_rank, rank[mu])`` partial contractions."""


class CansketchTucker(DRM, ABC):
    @abstractmethod
    def sketch_tucker(self, tensor) -> List[torch.Tensor]:
        """Per-mode ``(prod(tucker_rank[:mu+1]), rank[mu])`` contractions."""
