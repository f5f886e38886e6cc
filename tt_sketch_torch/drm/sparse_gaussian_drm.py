"""Lazy Gaussian DRM: entries generated on demand by the counter-based hash.

Counterpart of ``tt_sketch_tpu/drm/sparse_gaussian_drm.py``.  Mathematically
a dense Gaussian DRM, but only the rows at a sparse tensor's nnz indices are
generated, from ``(seed, index, column)`` alone.  Generator step μ uses the
seed ``(seed + μ) mod 2^63``.

The dtype picks the uniform → normal map:

- float32 and bfloat16 take the kernel contract (24-bit uniform plus a half
  ulp, Giles float32 erfinv): ``kernels/lazy_gaussian.lazy_gaussian``, which
  runs the CUDA kernel on a CUDA tensor and its plain version on the CPU;
- float64 takes the parity path (52-bit uniform, ``ndtri``).

The JAX package gates the first on "TPU and float32/bfloat16"
(``_use_pallas``), so on its CPU backend float32 takes the parity path
rounded to float32.  The port's gate is the dtype alone.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from tt_sketch_torch.drm.base import (
    CanIncreaseRank,
    CansketchSparse,
    LazyModeList,
    handle_transpose,
)
from tt_sketch_torch.kernels.lazy_gaussian import lazy_gaussian
from tt_sketch_torch.rng.hash_rng import drm_salts, flat_index, inds_to_normal

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def step_seed(seed: int, mu: int) -> int:
    """The seed of generator step ``mu``: ``(seed + mu) mod 2^63``."""
    return (int(seed) + int(mu)) % (1 << 63)


class SparseGaussianDRM(CansketchSparse, CanIncreaseRank):
    def __init__(
        self,
        rank: Union[Tuple[int, ...], int],
        shape: Tuple[int, ...],
        transpose: bool,
        seed: Optional[int] = None,
        **kwargs,
    ) -> None:
        super().__init__(rank, shape, transpose, seed=seed, **kwargs)

    @property
    def uses_kernel_contract(self) -> bool:
        """float32/bfloat16: rows follow the CUDA generator's contract."""
        return self.dtype in KERNEL_DTYPES

    def salts(self, mu: int) -> torch.Tensor:
        """int64 column salts of generator step ``mu`` (its rank slice)."""
        return drm_salts(self.rank_min[mu], self.rank_max[mu],
                         step_seed(self.seed, mu), device=self.device)

    def side_spec(self, mu: int) -> tuple:
        """The fused kernels' description of step ``mu``: ``("g",)``, one
        row per salt."""
        return ("g",)

    @handle_transpose
    def sketch_sparse(self, tensor) -> List[torch.Tensor]:
        """Per-mode ``(rank[mu], nnz)`` rows at the nnz prefix indices,
        generated lazily on first access."""

        def mode(mu: int) -> torch.Tensor:
            prefix = tensor.indices[: mu + 1]
            if self.uses_kernel_contract:
                flat = flat_index(prefix, tensor.shape[: mu + 1])
                return lazy_gaussian(flat, self.salts(mu)).to(self.dtype)
            return inds_to_normal(
                prefix, tensor.shape[: mu + 1], self.rank_min[mu],
                self.rank_max[mu], step_seed(self.seed, mu), dtype=self.dtype,
            ).T

        return LazyModeList(mode, len(tensor.shape) - 1)
