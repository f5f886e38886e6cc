"""Sparse-sign DRM: each row has exactly ``nnz_per_row`` hashed ±1 entries.

Counterpart of ``tt_sketch_tpu/drm/sparse_sign_drm.py``.  Supports
``CanSlice`` (a rank block is a slice of the full shuffle) but not rank
increase: the in-row permutation is not prefix-stable in rank.  Generator
step μ uses the seed ``(seed + μ) mod 2^63`` and the salts of columns
``[0, nnz[μ])``, whatever the rank slice.

The dtype picks the contract, as for ``SparseGaussianDRM``: float32 and
bfloat16 take the kernel contract (exact integer swap positions,
``kernels/sparse_sign.sparse_sign_rows``: the CUDA kernel on a CUDA tensor,
its plain version on the CPU); float64 takes the parity path (swap
positions from float64 products, ``hash_rng.inds_to_sparse_sign``).  The
two agree unless a product lies within 2^-42 of an integer.

``num_non_zero_per_row`` defaults to the full rank per step.  As in the JAX
package it is stored as given: a right DRM (``transpose=True``) reads it in
its own reversed step order, ``.T`` does not reverse it, and ``slice``
drops an explicit value (the sliced DRM draws ``true_rank`` non-zeros).
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from tt_sketch_torch.drm.base import (
    CanSlice,
    CansketchSparse,
    LazyModeList,
    handle_transpose,
)
from tt_sketch_torch.drm.sparse_gaussian_drm import KERNEL_DTYPES, step_seed
from tt_sketch_torch.kernels.sparse_sign import sparse_sign_rows
from tt_sketch_torch.rng.hash_rng import (
    drm_salts,
    flat_index,
    inds_to_sparse_sign,
)


class SparseSignDRM(CansketchSparse, CanSlice):
    def __init__(
        self,
        rank: Union[Tuple[int, ...], int],
        shape: Tuple[int, ...],
        transpose: bool,
        seed: Optional[int] = None,
        num_non_zero_per_row: Optional[Tuple[int, ...]] = None,
        **kwargs,
    ) -> None:
        super().__init__(rank, shape, transpose, seed=seed, **kwargs)
        if num_non_zero_per_row is None:
            num_non_zero_per_row = self.true_rank
        self.nnz = tuple(int(n) for n in num_non_zero_per_row)

    @property
    def uses_kernel_contract(self) -> bool:
        """float32/bfloat16: rows follow the CUDA generator's contract."""
        return self.dtype in KERNEL_DTYPES

    def salts(self, mu: int) -> torch.Tensor:
        """int64 salts of generator step ``mu``: columns ``[0, nnz[mu])``."""
        return drm_salts(0, self.nnz[mu], step_seed(self.seed, mu),
                         device=self.device)

    def side_spec(self, mu: int) -> tuple:
        """The fused kernels' description of step ``mu``:
        ``("s", rank, nnz, rank_min, rows out)``."""
        return ("s", int(self.true_rank[mu]), int(self.nnz[mu]),
                int(self.rank_min[mu]),
                int(self.rank_max[mu] - self.rank_min[mu]))

    @handle_transpose
    def sketch_sparse(self, tensor) -> List[torch.Tensor]:
        """Per-mode ``(rank[mu], nnz)`` rows at the nnz prefix indices,
        generated lazily on first access."""

        def mode(mu: int) -> torch.Tensor:
            prefix = tensor.indices[: mu + 1]
            if self.uses_kernel_contract:
                flat = flat_index(prefix, tensor.shape[: mu + 1])
                return sparse_sign_rows(
                    flat, self.salts(mu), self.true_rank[mu], self.nnz[mu],
                    self.rank_min[mu], self.rank_max[mu]).to(self.dtype)
            return inds_to_sparse_sign(
                prefix, tensor.shape[: mu + 1], self.true_rank[mu],
                self.rank_min[mu], self.rank_max[mu], self.nnz[mu],
                step_seed(self.seed, mu), dtype=self.dtype,
            ).T

        return LazyModeList(mode, len(tensor.shape) - 1)
