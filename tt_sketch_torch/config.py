"""Global configuration for tt_sketch_torch: default dtype and device.

The accuracy contract of the JAX package (exact recovery of low-rank tensors
to ~1e-9 relative error) needs float64, so ``DEFAULT_DTYPE`` is float64.
torch's own default dtype is float32 and is never changed here: every
function that creates a tensor passes its dtype explicitly.

The default device is ``"cuda"``.  An entry point called with
``device=None`` runs there, and raises when no card is present instead of
continuing on the CPU.  Tests and CPU users call
``set_default_device("cpu")`` or pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

#: Default dtype for sketch computations (matches the JAX package's x64 mode).
DEFAULT_DTYPE = torch.float64

_default_device = torch.device("cuda")


def set_default_device(device) -> None:
    """Set the device that ``device=None`` means for every entry point."""
    global _default_device
    _default_device = torch.device(device)


def default_device() -> torch.device:
    return _default_device


def resolve_device(device=None) -> torch.device:
    """The concrete device for ``device`` (``None``: the package default).

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable.
    A CUDA device without an index resolves to the current CUDA device, so
    it compares equal to the ``.device`` of the tensors created on it.
    """
    dev = torch.device(device) if device is not None else _default_device
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tt_sketch_torch: a CUDA device was requested but "
                "torch.cuda.is_available() is False; pass device='cpu' or "
                "call tt_sketch_torch.config.set_default_device('cpu')"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
