"""Tensor-train format (counterpart of
``tt_sketch_tpu/formats/tensor_train.py``)."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tt_sketch_torch.config import DEFAULT_DTYPE, resolve_device
from tt_sketch_torch.formats import tt_ops
from tt_sketch_torch.formats.base import Tensor
from tt_sketch_torch.utils import TTRank, process_tt_rank, random_normal


class TensorTrain(Tensor):
    """TT with cores of shape ``(r_mu, n_mu, r_{mu+1})``, r_0 = r_d = 1."""

    def __init__(self, cores: List[torch.Tensor]) -> None:
        self.cores = list(cores)
        self.shape = tuple(int(C.shape[1]) for C in self.cores)
        self.rank = tuple(int(C.shape[0]) for C in self.cores[1:])

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.cores[0].dtype

    @property
    def T(self) -> TensorTrain:
        return TensorTrain([C.permute(2, 1, 0) for C in self.cores[::-1]])

    @property
    def size(self) -> int:
        return sum(int(np.prod(C.shape)) for C in self.cores)

    def to_dense(self) -> torch.Tensor:
        return tt_ops.tt_to_dense(self.cores)

    def gather(self, idx) -> torch.Tensor:
        """Entries at the (d, N) multi-indices ``idx``."""
        return tt_ops.tt_gather(self.cores, idx)

    def partial_dense(self, dir: str = "lr") -> List[torch.Tensor]:
        return tt_ops.tt_partial_dense(self.cores, dir)

    def norm(self) -> float:
        return tt_ops.tt_norm(self.cores)

    def orthogonalize(self) -> TensorTrain:
        return TensorTrain(tt_ops.tt_orthogonalize(self.cores))

    def round(
        self,
        eps: Optional[float] = None,
        max_rank: Optional[TTRank] = None,
        orthogonalized: bool = False,
    ) -> TensorTrain:
        """TT-SVD rounding (``tt_sketch_tpu/formats/tensor_train.py:65-83``).

        With ``eps=None`` and a ``max_rank`` the cut is the rank cap alone,
        so the sweep with no host read of singular values is used
        (``tt_ops.tt_round_fixed_rank``); otherwise ``tt_ops.tt_round``."""
        if eps is None and max_rank is not None:
            return TensorTrain(
                tt_ops.tt_round_fixed_rank(self.cores, max_rank,
                                           orthogonalized)
            )
        return TensorTrain(
            tt_ops.tt_round(self.cores, eps, max_rank, orthogonalized)
        )

    def round_masked(
        self,
        eps=None,
        max_rank: Optional[TTRank] = None,
        orthogonalized: bool = False,
    ) -> Tuple[TensorTrain, torch.Tensor]:
        """Device-resident eps-rounding with static shapes
        (``tt_ops.tt_round_masked``): ``(rounded, eff_ranks)``, the entries
        past the effective ranks exact zeros; ``trim_to_ranks`` slices them
        off after one host read."""
        cores, eff = tt_ops.tt_round_masked(
            self.cores, eps, max_rank, orthogonalized
        )
        return TensorTrain(cores), eff

    def trim_to_ranks(self, ranks) -> TensorTrain:
        """Slice cores to the given ranks (exact on masked TTs)."""
        return TensorTrain(tt_ops.tt_slice_to_ranks(self.cores, ranks))

    def norm_device(self) -> torch.Tensor:
        """``norm()`` as a 0-d device tensor (no host sync)."""
        return tt_ops.tt_norm_device(self.cores)

    def dot_device(self, other: TensorTrain) -> torch.Tensor:
        """TT-TT inner product as a 0-d device tensor (no host sync)."""
        return tt_ops.tt_dot(self.cores, other.cores)

    def svdvals(self) -> List[np.ndarray]:
        return tt_ops.tt_svdvals(self.cores)

    def add(self, other: TensorTrain) -> TensorTrain:
        """Direct-sum addition."""
        return TensorTrain(tt_ops.tt_add(self.cores, other.cores))

    def dot(self, other, reverse: bool = False) -> float:
        if isinstance(other, TensorTrain):
            return float(tt_ops.tt_dot(self.cores, other.cores))
        return super().dot(other, reverse=reverse)

    def error(
        self,
        other,
        relative: bool = False,
        rmse: bool = False,
        fast: bool = False,
    ) -> float:
        """Fast exact TT-TT error via ``(self - other)`` direct sum + norm."""
        if hasattr(other, "to_tt") and not isinstance(other, TensorTrain):
            other = other.to_tt()
        if isinstance(other, TensorTrain):
            err = self.add(other * -1.0).norm()
            if relative:
                other_norm = other.norm()
                if other_norm == 0:
                    return float(np.inf)
                err /= other_norm
            if rmse:
                err /= float(np.sqrt(np.prod(self.shape)))
            return err
        return super().error(other, relative=relative, rmse=rmse, fast=fast)

    def __mul__(self, other: float) -> TensorTrain:
        new_cores = list(self.cores)
        new_cores[-1] = new_cores[-1] * other
        return TensorTrain(new_cores)

    __rmul__ = __mul__

    def __repr__(self) -> str:
        return f"<Tensor train of shape {self.shape} with rank {self.rank}>"

    # -- constructors -------------------------------------------------------

    @classmethod
    def random(
        cls,
        shape: Tuple[int, ...],
        rank: TTRank,
        seed: Optional[int] = None,
        orthog: bool = False,
        trim: Optional[bool] = None,
        norm_goal: str = "norm-1",
        dtype=None,
        device=None,
    ) -> TensorTrain:
        """Random TT; cores scaled so E‖TT‖_F = 1 (``norm-1``) or so each
        core preserves norms (``norm-preserve``, used by the TT-DRM).

        Per-core seeds and the fill are the JAX package's, so the cores are
        bit-identical to ``tt_sketch_tpu``'s for equal seeds (``orthog``
        cores agree up to the QR's rounding and sign convention).
        """
        d = len(shape)
        if trim is None:
            trim = bool(orthog)
        if orthog and not trim:
            raise ValueError("Trimming must be enabled when orthogonalizing.")
        rank = process_tt_rank(rank, shape, trim=trim)
        rank_augmented = (1,) + tuple(rank) + (1,)

        seeds = np.random.SeedSequence(seed).generate_state(d)
        cores = []
        for i in range(d):
            r1, r2, n = rank_augmented[i], rank_augmented[i + 1], shape[i]
            core = random_normal(
                (r1 * n, r2), seed=int(seeds[i]), dtype=dtype, device=device
            )
            if orthog and i < d - 1:
                core, _ = torch.linalg.qr(core)
            elif norm_goal == "norm-1":
                core = core / float(np.sqrt(r1 * n))
            elif norm_goal == "norm-preserve":
                core = core / float(np.sqrt(r1))
            else:
                raise ValueError(f"Unknown norm goal: {norm_goal}")
            cores.append(core.reshape(r1, n, r2))
        return cls(cores)

    @classmethod
    def zero(cls, shape: Tuple[int, ...], rank: TTRank, dtype=None,
             device=None) -> TensorTrain:
        dtype = dtype or DEFAULT_DTYPE
        device = resolve_device(device)
        rank = process_tt_rank(rank, shape, trim=False)
        cores = [
            torch.zeros((r1, n, r2), dtype=dtype, device=device)
            for r1, n, r2 in zip((1,) + rank, shape, rank + (1,))
        ]
        return cls(cores)
