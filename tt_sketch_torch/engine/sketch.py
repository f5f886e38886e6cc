"""Sketch API: the streaming (STTA) ``stream_sketch`` with
``SketchedTensorTrain`` and the recovery ``assemble_sketched_tt``, and the
sequential one-pass sweeps ``hmt_sketch`` and ``orthogonal_sketch`` (OTTS),
which return a ``TensorTrain``.

Counterpart of ``tt_sketch_tpu/engine/sketch.py`` on dense, TT and sparse
input.  The right seed is derived as in the JAX package,
``(seed + splitmix_hash(d)) mod 2^32``, so equal seeds give equal DRMs.
Blocked sketches and rank growth come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Type

import numpy as np
import torch

from tt_sketch_torch.drm import TensorTrainDRM
from tt_sketch_torch.drm.base import DRM
from tt_sketch_torch.engine.dispatch import SketchMethod, general_sketch
from tt_sketch_torch.engine.sketch_container import SketchContainer
from tt_sketch_torch.formats.base import Tensor
from tt_sketch_torch.formats.tensor_train import TensorTrain
from tt_sketch_torch.rng.hash_rng import hash_int_np
from tt_sketch_torch.utils import (
    TTRank,
    left_mul_pinv,
    process_tt_rank,
    right_mul_pinv,
)


def _derive_right_seed(seed: int, d: int) -> int:
    """Deterministic right-DRM seed (the JAX package's rule)."""
    h = int(hash_int_np(np.array([d], dtype=np.uint64))[0])
    return int((seed + h) % (2 ** 32))


def _rank_matches(drm_rank, requested, shape) -> bool:
    """A provided DRM's rank may be the trimmed or untrimmed normalization
    of the requested rank."""
    drm_rank = tuple(drm_rank)
    return drm_rank in (
        tuple(process_tt_rank(requested, shape, trim=False)),
        tuple(process_tt_rank(requested, shape, trim=True)),
    )


def _random_seed() -> int:
    return int(np.random.default_rng().integers(0, 2 ** 32))


def _resolve_drm_types(left_type, right_type):
    if left_type is None:
        left_type = right_type if right_type is not None else TensorTrainDRM
    if right_type is None:
        right_type = left_type
    return left_type, right_type


def hmt_sketch(
    tensor: Tensor,
    rank: TTRank,
    seed: Optional[int] = None,
    drm_type: Optional[Type[DRM]] = None,
    drm: Optional[DRM] = None,
    return_drm: bool = False,
    dtype=None,
    compile: bool = False,
    device=None,
):
    """One-sided Halko–Martinsson–Tropp-style sweep; returns a TensorTrain.

    The DRM (default ``TensorTrainDRM``) is a right DRM; the left side of
    every Ψ is the chain of the cores orthogonalized so far.  ``compile`` is
    accepted for the JAX package's signature and does nothing: torch runs
    eagerly.  ``dtype``/``device`` as in ``stream_sketch``."""
    del compile
    if seed is None:
        seed = _random_seed()
    if drm is None:
        if drm_type is None:
            drm_type = TensorTrainDRM
        rank = process_tt_rank(rank, tensor.shape, trim=True)
        drm = drm_type(
            rank, transpose=True, shape=tensor.shape, seed=seed, dtype=dtype,
            device=device,
        )
    elif not _rank_matches(drm.rank[::-1], rank, tensor.shape):
        raise ValueError(
            f"Rank {rank} does not match the rank of the DRM {drm.rank}."
        )
    sketch = general_sketch(tensor, None, drm, method=SketchMethod.hmt)
    sketched = TensorTrain(sketch.Psi_cores)
    if return_drm:
        return sketched, drm
    return sketched


def orthogonal_sketch(
    tensor: Tensor,
    left_rank: TTRank,
    right_rank: TTRank,
    seed: Optional[int] = None,
    left_drm_type: Optional[Type[DRM]] = None,
    right_drm_type: Optional[Type[DRM]] = None,
    left_drm: Optional[DRM] = None,
    right_drm: Optional[DRM] = None,
    return_drm: bool = False,
    dtype=None,
    compile: bool = False,
    device=None,
):
    """Two-sided orthogonal sketch (OTTS); returns a TensorTrain.

    ``compile`` is accepted for the JAX package's signature and does
    nothing: torch runs eagerly.  ``dtype``/``device`` as in
    ``stream_sketch``."""
    del compile
    d = len(tensor.shape)
    if not bool(np.all(np.array(left_rank) < np.array(right_rank))):
        raise ValueError(
            f"The right rank needs to be larger than the left rank. "
            f"Left rank: {left_rank}, right rank: {right_rank}"
        )
    if seed is None:
        seed = _random_seed()

    left_drm_type, right_drm_type = _resolve_drm_types(
        left_drm_type, right_drm_type
    )
    if left_drm is None:
        left_rank = process_tt_rank(left_rank, tensor.shape, trim=True)
        left_drm = left_drm_type(
            left_rank, transpose=False, shape=tensor.shape, seed=seed,
            dtype=dtype, device=device,
        )
    elif not _rank_matches(left_drm.rank, left_rank, tensor.shape):
        raise ValueError(
            f"Left rank {left_rank} does not match the DRM rank {left_drm.rank}."
        )
    if right_drm is None:
        right_rank = process_tt_rank(right_rank, tensor.shape, trim=False)
        right_drm = right_drm_type(
            right_rank,
            transpose=True,
            shape=tensor.shape,
            seed=_derive_right_seed(seed, d),
            dtype=dtype,
            device=device,
        )
    elif not _rank_matches(right_drm.rank[::-1], right_rank, tensor.shape):
        raise ValueError(
            f"Right rank {right_rank} does not match the DRM rank "
            f"{right_drm.rank}."
        )

    sketch = general_sketch(
        tensor, left_drm, right_drm, method=SketchMethod.orthogonal
    )
    sketched = TensorTrain(sketch.Psi_cores)
    if return_drm:
        return sketched, left_drm, right_drm
    return sketched


def stream_sketch(
    tensor: Tensor,
    left_rank: TTRank,
    right_rank: TTRank,
    seed: Optional[int] = None,
    left_drm_type: Optional[Type[DRM]] = None,
    right_drm_type: Optional[Type[DRM]] = None,
    left_drm: Optional[DRM] = None,
    right_drm: Optional[DRM] = None,
    return_drm: bool = False,
    dtype=None,
    compile: bool = False,
    device=None,
):
    """Two-sided streaming (STTA) sketch; returns a ``SketchedTensorTrain``
    that supports exact updates (``+ tensor``) and cheap recovery.

    DRMs not given are built with ``dtype`` (default float64) on ``device``
    (default: the package default device); the tensor must lie on the same
    device with the same dtype.  ``compile`` is accepted for the JAX
    package's signature and does nothing: torch runs eagerly.
    """
    del compile
    d = len(tensor.shape)
    left_rank_bigger = bool(np.all(np.array(left_rank) > np.array(right_rank)))
    right_rank_bigger = bool(np.all(np.array(left_rank) < np.array(right_rank)))
    if not left_rank_bigger and not right_rank_bigger:
        raise ValueError(
            f"Left ranks or right ranks must be consistently larger or "
            f"smaller than the other. Left rank: {left_rank}, "
            f"right rank: {right_rank}"
        )
    if seed is None:
        seed = _random_seed()

    left_drm_type, right_drm_type = _resolve_drm_types(
        left_drm_type, right_drm_type
    )
    if left_drm is None:
        left_rank = process_tt_rank(
            left_rank, tensor.shape, trim=right_rank_bigger
        )
        left_drm = left_drm_type(
            left_rank, transpose=False, shape=tensor.shape, seed=seed,
            dtype=dtype, device=device,
        )
    elif not _rank_matches(left_drm.rank, left_rank, tensor.shape):
        raise ValueError(
            f"Left rank {left_rank} does not match the DRM rank {left_drm.rank}."
        )
    if right_drm is None:
        right_rank = process_tt_rank(
            right_rank, tensor.shape, trim=left_rank_bigger
        )
        right_drm = right_drm_type(
            right_rank,
            transpose=True,
            shape=tensor.shape,
            seed=_derive_right_seed(seed, d),
            dtype=dtype,
            device=device,
        )
    elif not _rank_matches(right_drm.rank[::-1], right_rank, tensor.shape):
        raise ValueError(
            f"Right rank {right_rank} does not match the DRM rank "
            f"{right_drm.rank}."
        )

    sketch = general_sketch(
        tensor, left_drm, right_drm, method=SketchMethod.streaming
    )
    sketched = SketchedTensorTrain(sketch, left_drm, right_drm)
    if return_drm:
        return sketched, left_drm, right_drm
    return sketched


@dataclass
class SketchedTensorTrain(Tensor):
    """Sketch state + the DRMs that produced it.

    Cheap to convert to a TT; ``+ tensor`` re-sketches the new tensor with
    the *same* DRMs and adds containers (exact streaming update).
    """

    sketch_: SketchContainer
    left_drm: DRM
    right_drm: DRM

    def __post_init__(self):
        self.shape = self.sketch_.shape

    @property
    def left_rank(self) -> Tuple[int, ...]:
        return self.left_drm.rank

    @property
    def right_rank(self) -> Tuple[int, ...]:
        return self.right_drm.rank[::-1]

    @property
    def Psi_cores(self):
        return self.sketch_.Psi_cores

    @property
    def Omega_mats(self):
        return self.sketch_.Omega_mats

    @property
    def size(self) -> int:
        return sum(int(np.prod(P.shape)) for P in self.Psi_cores) + sum(
            int(np.prod(O.shape)) for O in self.Omega_mats
        )

    def C_cores(self, direction: str = "auto") -> List[torch.Tensor]:
        return assemble_sketched_tt(self.sketch_, direction=direction)

    @property
    def T(self) -> "SketchedTensorTrain":
        return SketchedTensorTrain(
            self.sketch_.T, self.right_drm.T, self.left_drm.T
        )

    def to_tt(self) -> TensorTrain:
        return TensorTrain(self.C_cores())

    def to_dense(self) -> torch.Tensor:
        return self.to_tt().to_dense()

    def __add__(self, other: Tensor) -> "SketchedTensorTrain":
        other_sketch = stream_sketch(
            other,
            self.left_rank,
            self.right_rank,
            left_drm=self.left_drm,
            right_drm=self.right_drm,
        )
        return SketchedTensorTrain(
            self.sketch_ + other_sketch.sketch_, self.left_drm, self.right_drm
        )

    def __mul__(self, other: float) -> "SketchedTensorTrain":
        return SketchedTensorTrain(
            self.sketch_ * other, self.left_drm, self.right_drm
        )

    def dot(self, other, reverse: bool = False) -> float:
        return self.to_tt().dot(other, reverse)

    def __repr__(self) -> str:
        return (
            f"<Sketched tensor train of shape {self.shape} with left-rank "
            f"{self.left_rank} and right-rank {self.right_rank}>"
        )


def assemble_sketched_tt(
    sketch: SketchContainer, direction: str = "auto"
) -> List[torch.Tensor]:
    """Recover TT cores: ``C_μ = Ψ_μ Ω_μ⁺`` (right sweep) or
    ``Ω_{μ-1}⁺ Ψ_μ`` (left sweep), direction chosen by the bigger side."""
    if direction == "auto":
        left_bigger = bool(
            np.all(np.array(sketch.left_rank) > np.array(sketch.right_rank))
        )
        direction = "left" if left_bigger else "right"

    tt_cores: List[torch.Tensor] = []
    if direction == "right":
        for Psi, Omega in zip(sketch.Psi_cores[:-1], sketch.Omega_mats):
            r1, n, r2 = Psi.shape
            core = right_mul_pinv(Psi.reshape(r1 * n, r2), Omega)
            tt_cores.append(core.reshape(r1, n, Omega.shape[0]))
        tt_cores.append(sketch.Psi_cores[-1])
    elif direction == "left":
        tt_cores.append(sketch.Psi_cores[0])
        for Psi, Omega in zip(sketch.Psi_cores[1:], sketch.Omega_mats):
            r1, n, r2 = Psi.shape
            core = left_mul_pinv(Omega, Psi.reshape(r1, n * r2))
            tt_cores.append(core.reshape(Omega.shape[1], n, r2))
    else:
        raise ValueError(f"Unknown direction {direction}")
    return tt_cores
