"""Sketch API: the streaming (STTA) ``stream_sketch`` with
``SketchedTensorTrain`` and the recovery ``assemble_sketched_tt``, the
sequential one-pass sweeps ``hmt_sketch`` and ``orthogonal_sketch`` (OTTS),
which return a ``TensorTrain``, blocked sketches and rank growth.

Counterpart of ``tt_sketch_tpu/engine/sketch.py``.  The right seed is
derived as in the JAX package, ``(seed + splitmix_hash(d)) mod 2^32``, so
equal seeds give equal DRMs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.drm import ALL_DRM, SparseGaussianDRM, TensorTrainDRM
from tt_sketch_torch.drm.base import (
    DRM,
    CanIncreaseRank,
    CanSlice,
    CansketchCP,
    CansketchDense,
    CansketchSparse,
    CansketchTT,
    CansketchTucker,
)
from tt_sketch_torch.engine.dispatch import SketchMethod, general_sketch
from tt_sketch_torch.engine.sketch_container import SketchContainer
from tt_sketch_torch.formats.base import Tensor
from tt_sketch_torch.formats.tensor_train import TensorTrain
from tt_sketch_torch.rng.hash_rng import hash_int_np
from tt_sketch_torch.utils import TTRank, lstsq_each, process_tt_rank

DEFAULT_DRM = {
    CansketchDense: TensorTrainDRM,
    CansketchSparse: SparseGaussianDRM,
    CansketchTT: TensorTrainDRM,
    CansketchCP: TensorTrainDRM,
    CansketchTucker: TensorTrainDRM,
}

BlockedSketch = Dict[Tuple[int, int], SketchContainer]


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


@profiling.spanned("tt.hmt_sketch")
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


@profiling.spanned("tt.orthogonal_sketch")
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


@profiling.spanned("tt.stream_sketch")
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

    @profiling.spanned("tt.to_tt")
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

    def increase_rank(
        self,
        tensor: Tensor,
        new_left_rank: TTRank,
        new_right_rank: TTRank,
    ) -> "SketchedTensorTrain":
        """Grow the sketch ranks, computing only the new rank blocks; the
        old container becomes block (0, 0) (prefix stability of the
        DRMs)."""
        new_left_rank = process_tt_rank(new_left_rank, tensor.shape,
                                        trim=False)
        new_right_rank = process_tt_rank(new_right_rank, tensor.shape,
                                         trim=False)
        for drm in (self.left_drm, self.right_drm):
            if not isinstance(drm, CanSlice):
                raise ValueError(
                    f"Increasing rank is not supported for DRM "
                    f"{drm.__class__.__name__}"
                )

        n_dims = len(tensor.shape)
        left_rank_slices = [
            (0,) * (n_dims - 1),
            self.left_drm.rank,
            new_left_rank,
        ]
        right_rank_slices = [
            (0,) * (n_dims - 1),
            self.right_drm.rank[::-1],
            new_right_rank,
        ]
        left_drm = self.left_drm.increase_rank(new_left_rank)
        right_drm = self.right_drm.increase_rank(new_right_rank)

        sketch_dict = _blocked_stream_sketch_components(
            tensor,
            left_drm,
            right_drm,
            left_rank_slices,
            right_rank_slices,
            excluded_entries=[(0, 0)],
        )
        sketch_dict[(0, 0)] = self.sketch_
        sketch = _assemble_blocked_stream_sketches(
            left_rank_slices, right_rank_slices, tensor.shape, sketch_dict
        )
        return SketchedTensorTrain(sketch, left_drm, right_drm)

    def __repr__(self) -> str:
        return (
            f"<Sketched tensor train of shape {self.shape} with left-rank "
            f"{self.left_rank} and right-rank {self.right_rank}>"
        )


@profiling.spanned("tt.recover")
def assemble_sketched_tt(
    sketch: SketchContainer, direction: str = "auto"
) -> List[torch.Tensor]:
    """Recover TT cores: ``C_μ = Ψ_μ Ω_μ⁺`` (right sweep) or
    ``Ω_{μ-1}⁺ Ψ_μ`` (left sweep), direction chosen by the bigger side.

    Every solve is ``utils._lstsq``'s; the Ω of one shape are factored
    together (``utils.lstsq_each``), on a card in one launch."""
    if direction == "auto":
        left_bigger = bool(
            np.all(np.array(sketch.left_rank) > np.array(sketch.right_rank))
        )
        direction = "left" if left_bigger else "right"

    if direction == "right":
        # Ψ Ω⁺ = (Ω^T⁺ Ψ^T)^T
        Psis, Omegas = sketch.Psi_cores[:-1], sketch.Omega_mats
        sols = lstsq_each([
            (Omega.mT, Psi.reshape(Psi.shape[0] * Psi.shape[1],
                                   Psi.shape[2]).mT)
            for Psi, Omega in zip(Psis, Omegas)])
        return [sol.mT.reshape(Psi.shape[0], Psi.shape[1], Omega.shape[0])
                for sol, Psi, Omega in zip(sols, Psis, Omegas)
                ] + [sketch.Psi_cores[-1]]
    if direction == "left":
        Psis, Omegas = sketch.Psi_cores[1:], sketch.Omega_mats
        sols = lstsq_each([
            (Omega, Psi.reshape(Psi.shape[0], Psi.shape[1] * Psi.shape[2]))
            for Psi, Omega in zip(Psis, Omegas)])
        return [sketch.Psi_cores[0]] + [
            sol.reshape(Omega.shape[1], Psi.shape[1], Psi.shape[2])
            for sol, Psi, Omega in zip(sols, Psis, Omegas)]
    raise ValueError(f"Unknown direction {direction}")


def _blocked_stream_sketch_components(
    tensor: Tensor,
    left_drm: CanSlice,
    right_drm: CanSlice,
    left_rank_slices: List[Tuple[int, ...]],
    right_rank_slices: List[Tuple[int, ...]],
    excluded_entries: Optional[Sequence[Tuple[int, int]]] = None,
) -> BlockedSketch:
    """The streaming sketch of every (left block, right block) pair of the
    rank slices, but the excluded ones."""
    if excluded_entries is None:
        excluded_entries = []
    left_blocks = [
        left_drm.slice(r1, r2)
        for r1, r2 in zip(left_rank_slices[:-1], left_rank_slices[1:])
    ]
    right_blocks = [
        right_drm.slice(r1, r2)
        for r1, r2 in zip(right_rank_slices[:-1], right_rank_slices[1:])
    ]
    sketch_dict: BlockedSketch = {}
    for i, lb in enumerate(left_blocks):
        for j, rb in enumerate(right_blocks):
            if (i, j) in excluded_entries:
                continue
            sketch_dict[(i, j)] = general_sketch(
                tensor, lb, rb, method=SketchMethod.streaming
            )
    return sketch_dict


def _assemble_blocked_stream_sketches(
    left_rank_slices: List[Tuple[int, ...]],
    right_rank_slices: List[Tuple[int, ...]],
    shape: Tuple[int, ...],
    sketch_dict: BlockedSketch,
) -> SketchContainer:
    """One container at the last slices' ranks, each block written into
    its slice of a zero container (pure indexing)."""
    left_rank = tuple(left_rank_slices[-1])
    right_rank = tuple(right_rank_slices[-1])
    first = sketch_dict[(0, 0)].Psi_cores[0]

    sketch = SketchContainer.zero(shape, left_rank, right_rank,
                                  dtype=first.dtype, device=first.device)
    for (i, j), block in sketch_dict.items():
        l1 = (0,) + tuple(left_rank_slices[i])
        l2 = (1,) + tuple(left_rank_slices[i + 1])
        r1 = tuple(right_rank_slices[j]) + (0,)
        r2 = tuple(right_rank_slices[j + 1]) + (1,)
        for mu, Psi in enumerate(block.Psi_cores):
            sketch.Psi_cores[mu][l1[mu]: l2[mu], :, r1[mu]: r2[mu]] = Psi
        for mu, Omega in enumerate(block.Omega_mats):
            sketch.Omega_mats[mu][l1[mu + 1]: l2[mu + 1],
                                  r1[mu]: r2[mu]] = Omega
    return sketch


def blocked_stream_sketch(
    tensor: Tensor,
    left_drm: CanSlice,
    right_drm: CanSlice,
    left_rank_slices: List[Tuple[int, ...]],
    right_rank_slices: List[Tuple[int, ...]],
) -> SketchContainer:
    """Streaming sketch computed in rank blocks: each block is an
    independent sub-sketch with sliced DRMs; assembly is pure indexing."""
    for drm in (left_drm, right_drm):
        if not isinstance(drm, CanSlice):
            raise ValueError(
                f"Blocked sketch not supported for DRM "
                f"{drm.__class__.__name__}"
            )
    sketch_dict = _blocked_stream_sketch_components(
        tensor, left_drm, right_drm, left_rank_slices, right_rank_slices
    )
    return _assemble_blocked_stream_sketches(
        left_rank_slices, right_rank_slices, tensor.shape, sketch_dict
    )


def get_drm_capabilities():
    """Capability matrix of all DRM types."""
    all_capabilities = {}
    for drm in ALL_DRM:
        caps = {}
        for capability in (
            CanSlice,
            CanIncreaseRank,
            CansketchSparse,
            CansketchDense,
            CansketchTT,
            CansketchCP,
            CansketchTucker,
        ):
            caps[capability.__name__] = issubclass(drm, capability)
        all_capabilities[drm.__name__] = caps
    return all_capabilities
