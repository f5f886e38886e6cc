"""Frozen copy of the hashed-DRM contract, for the plain reference.

A hashed DRM entry is a pure function of (multi-index, column, seed): the
prefix multi-index is flattened column-major (first mode fastest, mod
2^64), a column salt ``splitmix(col) + (seed mod 2^63)`` is added, and the
sum is hashed once more with the same splitmix64 avalanche.

- Gaussian rows: ``u24`` = hash bits 28..51, ``x = (2 u24 + 1 - 2^24) /
  2^24`` and the entry is ``sqrt(2) erfinv(x)``, here in float64 (the
  program's float32 polynomial agrees within a few float32 ulps).
- Sign rows (``nnz`` non-zeros in a column of ``rank`` slots): slots
  ``j < nnz`` take ``2 bit52(h_j) - 1`` for the hash ``h_j`` of column
  ``j``, then a Fisher-Yates pass swaps slot ``j`` with slot
  ``floor(u52_j (rank - j) / 2^52) + j``, ``u52`` the low 52 bits.
- Generator step ``mu`` of a DRM seeded ``s`` uses the seed ``(s mod (2^32
  - 1) + mu) mod 2^63``.  A right DRM is a left DRM of the tensor with its
  modes reversed; ``stream_sketch`` seeds it ``(s + splitmix(d)) mod 2^32``.

Torch int64 arithmetic wraps mod 2^64 like uint64; a logical right shift
is an arithmetic one masked.  Imports only torch.
"""
from __future__ import annotations

import math

import torch

_ADD1 = 0x4BE98134A5976FD3
_MULT1 = 0xBF58476D1CE4E5B9
_MULT2 = 0x94D049BB133111EB
_MASK52 = (1 << 52) - 1


def _signed(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix(x: torch.Tensor) -> torch.Tensor:
    """The avalanche hash on int64 bit patterns."""
    r = x + _signed(_ADD1)
    r = r ^ _lshr(r, 30)
    r = r * _signed(_MULT1)
    r = r ^ _lshr(r, 27)
    r = r * _signed(_MULT2)
    return r ^ _lshr(r, 31)


def splitmix_int(v: int) -> int:
    """The avalanche hash of one Python integer, as an unsigned value."""
    m = (1 << 64) - 1
    r = (v + _ADD1) & m
    r ^= r >> 30
    r = (r * _MULT1) & m
    r ^= r >> 27
    r = (r * _MULT2) & m
    return r ^ (r >> 31)


def drm_seed(seed: int) -> int:
    """The seed a DRM keeps from the one it is given."""
    return int(seed) % (2 ** 32 - 1)


def right_seed(seed: int, d: int) -> int:
    """The right DRM's seed of ``stream_sketch(seed=seed)`` on ``d`` modes."""
    return (int(seed) + splitmix_int(d)) % (2 ** 32)


def step_seed(seed: int, mu: int) -> int:
    return (drm_seed(seed) + int(mu)) % (1 << 63)


def flat_prefix(indices: torch.Tensor, shape) -> torch.Tensor:
    """Column-major flat index of the (k, N) prefix indices over ``shape``."""
    flat = indices[0].to(torch.int64).clone()
    prod = 1
    for i in range(1, indices.shape[0]):
        prod = (prod * int(shape[i - 1])) % (1 << 64)
        flat = flat + indices[i].to(torch.int64) * _signed(prod)
    return flat


def _hashes(flat: torch.Tensor, cols: int, seed: int) -> torch.Tensor:
    """(cols, N) hashes of the columns [0, cols)."""
    salts = splitmix(torch.arange(cols, dtype=torch.int64,
                                  device=flat.device)) + seed
    return splitmix(flat[None, :] + salts[:, None])


def gaussian_rows(flat: torch.Tensor, rank: int, seed: int) -> torch.Tensor:
    """(rank, N) float64 Gaussian rows of the step seeded ``seed``."""
    h = _hashes(flat, rank, seed)
    u24 = (_lshr(h, 28) & 0xFFFFFF).to(torch.float64)
    x = (2.0 * u24 + 1.0 - 2.0 ** 24) / 2.0 ** 24
    return math.sqrt(2.0) * torch.erfinv(x)


def sign_rows(flat: torch.Tensor, rank: int, nnz: int,
              seed: int) -> torch.Tensor:
    """(rank, N) float64 sign rows of the step seeded ``seed``."""
    h = _hashes(flat, nnz, seed)
    n = flat.shape[0]
    out = torch.zeros((rank, n), dtype=torch.float64, device=flat.device)
    out[:nnz] = (((h >> 52) & 1) * 2 - 1).to(torch.float64)
    u52 = h & _MASK52
    hi20, lo32 = u52 >> 32, u52 & 0xFFFFFFFF
    for j in range(nnz):
        m = rank - j
        pos = ((hi20[j] * m + ((lo32[j] * m) >> 32)) >> 20) + j
        vj = out[j].clone()
        out[j] = out.gather(0, pos[None, :])[0]
        out.scatter_(0, pos[None, :], vj[None, :])
    return out


def rows(kind: str, flat: torch.Tensor, rank: int, seed: int) -> torch.Tensor:
    """Rows of a hashed side: ``kind`` is ``gaussian`` or ``sign`` (every
    slot a non-zero, the DRM's default)."""
    if kind == "gaussian":
        return gaussian_rows(flat, rank, seed)
    if kind == "sign":
        return sign_rows(flat, rank, rank, seed)
    raise ValueError(f"unknown hashed DRM kind {kind!r}")

