"""Format × DRM dispatch and the general sketching engine.

Counterpart of ``tt_sketch_tpu/engine/dispatch.py``, streaming branch only:
for the streaming method the left/right contractions of every μ are
independent and the result is a linear function of the tensor.  A sparse
tensor with a float32/bfloat16 pair of hash-family DRMs
(``SparseGaussianDRM``, ``SparseSignDRM``) runs entirely through the fused
sparse kernels (``sparse_streaming_sketch_fused``).  The
orthogonal and HMT methods come with the sequential-methods slice.
"""
from __future__ import annotations

import enum
from typing import Callable, Dict, List

import torch

from tt_sketch_torch.engine.sketch_container import SketchContainer
from tt_sketch_torch.formats import DenseTensor, SparseTensor, TensorTrain
from tt_sketch_torch.kernels import sketch_kernels as K


class SketchMethod(enum.Enum):
    streaming = "streaming"
    orthogonal = "orthogonal"
    hmt = "hmt"


DRM_SKETCH_METHOD_DISPATCH = {
    SparseTensor: "sketch_sparse",
    TensorTrain: "sketch_tt",
    DenseTensor: "sketch_dense",
}

OMEGA_METHODS: Dict[type, Callable] = {
    SparseTensor: K.sketch_omega_sparse,
    TensorTrain: K.sketch_omega_tt,
    DenseTensor: K.sketch_omega_dense,
}

PSI_METHODS: Dict[type, Callable] = {
    SparseTensor: K.sketch_psi_sparse,
    TensorTrain: K.sketch_psi_tt,
    DenseTensor: K.sketch_psi_dense,
}


def get_sketch_method(tensor, drm) -> Callable:
    if type(tensor) in DRM_SKETCH_METHOD_DISPATCH:
        return getattr(drm, DRM_SKETCH_METHOD_DISPATCH[type(tensor)])
    raise ValueError(f"DRM of type {type(drm)} can't sketch {type(tensor)}")


def _check_placement(tensor, drm) -> None:
    """DRM and tensor must share device and dtype: torch neither moves nor
    promotes silently across them, and the port does not either.  A DRM
    with cores is where its cores are; a hash DRM is where it generates."""
    cores = getattr(drm, "cores", None)
    device = cores[0].device if cores else drm.device
    dtype = cores[0].dtype if cores else drm.dtype
    if device != tensor.device:
        raise ValueError(
            f"{drm!r} lies on {device}, the tensor on {tensor.device}"
        )
    if dtype != tensor.dtype:
        raise ValueError(
            f"{drm!r} has dtype {dtype}, the tensor {tensor.dtype}; "
            f"pass dtype= to the sketch"
        )


def general_sketch(
    tensor,
    left_drm,
    right_drm,
    method: SketchMethod,
) -> SketchContainer:
    """Compute the (Ψ, Ω) sketch of ``tensor`` with the given DRM pair."""
    if method != SketchMethod.streaming:
        raise NotImplementedError(
            f"method '{method.value}' comes with the sequential-methods slice "
            f"of the port"
        )
    if left_drm is None:
        raise ValueError(f"left_drm must be provided for method '{method}'")
    for drm in (left_drm, right_drm):
        _check_placement(tensor, drm)
    if isinstance(tensor, SparseTensor) and K.sparse_fused_applies(
        tensor, left_drm, right_drm
    ):
        Psi_cores, Omega_mats = K.sparse_streaming_sketch_fused(
            tensor, left_drm, right_drm
        )
        return SketchContainer(Psi_cores, Omega_mats)

    n_dims = len(tensor.shape)
    left_contractions = get_sketch_method(tensor, left_drm)(tensor)
    right_contractions = get_sketch_method(tensor, right_drm)(tensor)

    omega_method = OMEGA_METHODS[type(tensor)]
    Omega_mats: List[torch.Tensor] = [
        omega_method(
            left_contractions[mu], right_contractions[mu], tensor=tensor, mu=mu
        )
        for mu in range(n_dims - 1)
    ]

    psi_method = PSI_METHODS[type(tensor)]
    Psi_cores: List[torch.Tensor] = [
        psi_method(
            left_contractions[mu - 1] if mu > 0 else None,
            right_contractions[mu] if mu < n_dims - 1 else None,
            tensor=tensor,
            mu=mu,
        )
        for mu in range(n_dims)
    ]
    return SketchContainer(Psi_cores, Omega_mats)
