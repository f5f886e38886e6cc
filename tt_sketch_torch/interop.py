"""Hand numpy arrays (e.g. the JAX package's DRM cores and sketches, read
back with ``np.asarray``) to the port, keeping their dtype."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from tt_sketch_torch.config import resolve_device
from tt_sketch_torch.engine.sketch_container import SketchContainer


def from_numpy_cores(cores: Sequence[np.ndarray],
                     device=None) -> List[torch.Tensor]:
    """numpy arrays → torch tensors on ``device`` (default: package
    default), same dtype and values."""
    device = resolve_device(device)
    return [torch.from_numpy(np.array(c)).to(device) for c in cores]


def container_from_numpy(psi_list: Sequence[np.ndarray],
                         omega_list: Sequence[np.ndarray],
                         device=None) -> SketchContainer:
    """A ``SketchContainer`` from numpy Ψ cores and Ω matrices."""
    return SketchContainer(
        from_numpy_cores(psi_list, device), from_numpy_cores(omega_list, device)
    )
