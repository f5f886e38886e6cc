"""Splitmix64 avalanche hash on the host (numpy).

Counterpart of ``hash_int_np`` in ``tt_sketch_tpu/rng/hash_rng.py``; the
counter-based DRM generators built on it come with the sparse slice.
"""
from __future__ import annotations

import numpy as np

_SHIFT1, _SHIFT2, _SHIFT3 = np.uint64(30), np.uint64(27), np.uint64(31)
_MULT1 = np.uint64(0xBF58476D1CE4E5B9)
_MULT2 = np.uint64(0x94D049BB133111EB)
_ADD1 = np.uint64(0x4BE98134A5976FD3)


def hash_int_np(x: np.ndarray) -> np.ndarray:
    """Splitmix64-style avalanche hash of uint64 values (vectorized)."""
    with np.errstate(over="ignore"):
        r = x.astype(np.uint64, copy=True)
        r += _ADD1
        r ^= r >> _SHIFT1
        r *= _MULT1
        r ^= r >> _SHIFT2
        r *= _MULT2
        r ^= r >> _SHIFT3
    return r
