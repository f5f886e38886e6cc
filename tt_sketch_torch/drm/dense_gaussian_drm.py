"""Dense Gaussian DRM: explicit per-mode Gaussian matrices.

Counterpart of ``tt_sketch_tpu/drm/dense_gaussian_drm.py``.  The matrix of
mode μ is drawn on the host from ``default_rng(SeedSequence((seed, μ)))``
in float64, row-major so that the rank dimension is prefix-stable (which
makes ``CanIncreaseRank`` exact), then cast to the DRM's dtype and moved to
its device: the values equal the JAX package's bit for bit.  The DRM lies
where its matrices do (``device``, ``dtype`` from the DRM base).
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from tt_sketch_torch.drm.base import (
    CanIncreaseRank,
    CansketchDense,
    CansketchSparse,
    CansketchTT,
    handle_transpose,
)


class DenseGaussianDRM(
    CansketchTT, CansketchSparse, CansketchDense, CanIncreaseRank
):
    sketching_mats: List[torch.Tensor]

    def __init__(
        self,
        rank: Union[Tuple[int, ...], int],
        shape: Tuple[int, ...],
        transpose: bool,
        seed: Optional[int] = None,
        **kwargs,
    ) -> None:
        super().__init__(rank, shape, transpose, seed=seed, **kwargs)
        shape_sketch = self.shape[::-1] if transpose else self.shape

        self.sketching_mats = []
        dim_prod = 1
        for mu, (r, n) in enumerate(zip(self.true_rank, shape_sketch[:-1])):
            dim_prod *= n
            rng = np.random.default_rng(np.random.SeedSequence((self.seed, mu)))
            mat = rng.standard_normal(size=(r, dim_prod))
            mat = mat[self.rank_min[mu]: self.rank_max[mu]]
            self.sketching_mats.append(torch.from_numpy(mat).to(
                device=self.device, dtype=self.dtype))

    @handle_transpose
    def sketch_sparse(self, tensor) -> List[torch.Tensor]:
        """Per-mode ``(rank[mu], nnz)`` columns of the matrices at the
        nonzeros' C-order prefix indices (clipped to the prefix, as the JAX
        package's ``ravel_multi_index(mode="clip")``)."""
        out = []
        flat = torch.zeros_like(tensor.indices[0])
        for mu in range(len(tensor.shape) - 1):
            n = int(tensor.shape[mu])
            flat = flat * n + tensor.indices[mu].clamp(0, n - 1)
            out.append(self.sketching_mats[mu][:, flat])
        return out

    @handle_transpose
    def sketch_tt(self, tensor) -> List[torch.Tensor]:
        partials = tensor.partial_dense("lr")
        return [(sm @ pc).T for sm, pc in zip(self.sketching_mats, partials)]

    @handle_transpose
    def sketch_dense(self, tensor) -> List[torch.Tensor]:
        return list(self.sketching_mats)
