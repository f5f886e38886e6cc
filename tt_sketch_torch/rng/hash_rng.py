"""Counter-based lazy RNG: ``(multi-index, column, seed) -> N(0,1)``.

Counterpart of ``tt_sketch_tpu/rng/hash_rng.py``.  Every DRM entry is a
pure function of the seed: the multi-index is flattened column-major, a
per-column salt ``hash(col) + seed`` is added, and the sum is hashed with a
splitmix64-style avalanche hash.

Two uniform → normal maps share that hash:

- the **parity path** (float64): the low 52 hash bits as a uniform in
  [0, 1) and ``torch.special.ndtri``, as ``inds_to_normal`` in the JAX
  package;
- the **kernel contract** (float32/bfloat16 DRMs): the 24 hash bits 28..51
  plus a half ulp and ``√2·erfinv`` with Giles' single-precision
  polynomials (``normal_from_bits``), the same arithmetic as the CUDA
  generator in ``csrc/hash_rng.cuh``.

The sparse-sign generator (``nnz`` hashed ±1 per DRM row, shuffled over
``rank`` slots by a Fisher–Yates pass) has the same two contracts: the parity
path ``inds_to_sparse_sign`` draws swap positions as ``u52/2^52·(rank−j) + j``
in float64, the kernel contract ``sparse_sign_from_bits`` as the exact
integer ``floor(u52·(rank−j) / 2^52) + j``.  Its salts are those of columns
``[0, nnz)`` whatever rank slice is asked for.

Hashes run on torch ``int64`` tensors: torch has no ``uint64`` shift on the
CPU, and ``+``/``*`` on ``int64`` wrap mod 2^64 like ``uint64``.  The logical
right shift is written as ``(x >> s) & (2^(64-s) - 1)``.  The numpy
``hash_int_np``/``_flat_index_np`` stay as the host oracle.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_SHIFT1, _SHIFT2, _SHIFT3 = np.uint64(30), np.uint64(27), np.uint64(31)
_MULT1 = np.uint64(0xBF58476D1CE4E5B9)
_MULT2 = np.uint64(0x94D049BB133111EB)
_ADD1 = np.uint64(0x4BE98134A5976FD3)

_MASK52 = (1 << 52) - 1
_INV_2_52 = 2.0 ** -52
_INV_2_24 = 2.0 ** -24
_SQRT2_F32 = float(np.float32(math.sqrt(2.0)))

# Giles (2010) single-precision erfinv polynomials, highest degree first
# (the JAX package's ``pallas_rng._ERFINV_*``; csrc/hash_rng.cuh repeats
# them).
_ERFINV_CENTRAL = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_TAIL = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def to_signed64(v: int) -> int:
    """The int64 with the same 64 bits as the integer ``v`` mod 2^64."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


# ---------------------------------------------------------------------------
# numpy (host oracle)
# ---------------------------------------------------------------------------

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


def _flat_index_np(indices: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Column-major flatten (first mode fastest), uint64 with wraparound."""
    indices = indices.astype(np.uint64)
    flat = indices[0].copy()
    prod = np.uint64(shape[0])
    with np.errstate(over="ignore"):
        for i in range(1, len(shape)):
            flat += indices[i] * prod
            prod *= np.uint64(shape[i])
    return flat


def _hash_bits_np(flat: np.ndarray, rank_min: int, rank_max: int,
                  seed: int) -> np.ndarray:
    """Hashed uint64 per (index, column) pair; shape (N, rank_max-rank_min)."""
    salt = hash_int_np(np.arange(rank_min, rank_max, dtype=np.uint64))
    with np.errstate(over="ignore"):
        salt = salt + np.uint64(int(seed) % (1 << 63))
        h = flat[:, None] + salt[None, :]
    return hash_int_np(h)


def _uniform_from_bits_np(h: np.ndarray) -> np.ndarray:
    """The parity path's uniform on the host: low 52 bits / 2^52."""
    return (h & np.uint64(_MASK52)).astype(np.float64) * _INV_2_52


def inds_to_normal_np(indices: np.ndarray, shape: Sequence[int],
                      rank_min: int, rank_max: int,
                      seed: int) -> np.ndarray:
    """Host oracle of ``inds_to_normal``: (N, rank_max - rank_min) float64
    Gaussian DRM entries at (d, N) multi-indices, ``scipy.special.ndtri`` of
    the 52-bit uniforms."""
    import scipy.special

    flat = _flat_index_np(np.asarray(indices), shape)
    h = _hash_bits_np(flat, int(rank_min), int(rank_max), int(seed))
    return scipy.special.ndtri(_uniform_from_bits_np(h))


def inds_to_sparse_sign_np(indices: np.ndarray, shape: Sequence[int],
                           rank: int, rank_min: int, rank_max: int,
                           nnz_per_row: int, seed: int) -> np.ndarray:
    """Host oracle of ``inds_to_sparse_sign``: columns [rank_min, rank_max)
    of the (N, rank) sparse-sign rows as int16, ``nnz_per_row`` hashed ±1
    per row (salts of columns [0, nnz)) placed at slots j and swapped with
    slot ``floor(u_j·(rank − j)) + j`` in float64."""
    indices = np.asarray(indices)
    N = indices.shape[1]
    rank, nnz = int(rank), int(nnz_per_row)
    flat = _flat_index_np(indices, shape)
    h = _hash_bits_np(flat, 0, nnz, int(seed))  # (N, nnz)
    u = _uniform_from_bits_np(h)
    exponent = (h >> np.uint64(52)) & np.uint64(0x7FF)
    out = np.zeros((N, rank), dtype=np.int16)
    out[:, :nnz] = (exponent & np.uint64(1)).astype(np.int16) * 2 - 1
    rows = np.arange(N)
    for j in range(nnz):
        pos = (u[:, j] * (rank - j) + j).astype(np.int64)
        tmp = out[rows, j].copy()
        out[rows, j] = out[rows, pos]
        out[rows, pos] = tmp
    return out[:, rank_min:rank_max]


# ---------------------------------------------------------------------------
# torch int64
# ---------------------------------------------------------------------------

def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


_ADD1_I = to_signed64(int(_ADD1))
_MULT1_I = to_signed64(int(_MULT1))
_MULT2_I = to_signed64(int(_MULT2))


def hash_int(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 hash of ``hash_int_np`` on int64 bit patterns."""
    r = x.to(torch.int64) + _ADD1_I
    r = r ^ _lshr(r, 30)
    r = r * _MULT1_I
    r = r ^ _lshr(r, 27)
    r = r * _MULT2_I
    return r ^ _lshr(r, 31)


def flat_index(indices: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Column-major flat index of (d, N) indices as int64 bit patterns: the
    value of ``_flat_index_np`` mod 2^64."""
    indices = indices.to(torch.int64)
    flat = indices[0].clone()
    prod = 1
    for i in range(1, len(shape)):
        prod = (prod * int(shape[i - 1])) % (1 << 64)
        flat = flat + indices[i] * to_signed64(prod)
    return flat


def drm_salts(rank_min: int, rank_max: int, seed: int,
              device=None) -> torch.Tensor:
    """Per-column salts ``hash(col) + (seed mod 2^63)`` for columns
    ``[rank_min, rank_max)``, as int64 bit patterns."""
    cols = torch.arange(int(rank_min), int(rank_max), dtype=torch.int64,
                        device=device)
    return hash_int(cols) + int(seed) % (1 << 63)


def _hash_bits(flat: torch.Tensor, rank_min: int, rank_max: int,
               seed: int) -> torch.Tensor:
    """Hashed bits per (index, column) pair; shape (N, rank_max-rank_min)."""
    salts = drm_salts(rank_min, rank_max, seed, device=flat.device)
    return hash_int(flat[:, None] + salts[None, :])


def uniform_from_bits(h: torch.Tensor) -> torch.Tensor:
    """The parity path's uniform: low 52 bits / 2^52 in [0, 1), float64."""
    return (h & _MASK52).to(torch.float64) * _INV_2_52


def inds_to_normal(indices: torch.Tensor, shape: Sequence[int],
                   rank_min: int, rank_max: int, seed: int,
                   dtype=torch.float64) -> torch.Tensor:
    """Parity-path Gaussian DRM entries at (d, N) multi-indices:
    (N, rank_max - rank_min) ``ndtri`` of the 52-bit uniforms."""
    flat = flat_index(indices, shape)
    h = _hash_bits(flat, int(rank_min), int(rank_max), int(seed))
    return torch.special.ndtri(uniform_from_bits(h)).to(dtype)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision erfinv, operation for operation as the
    kernels evaluate it (without their fused multiply-adds)."""
    w = -torch.log((1.0 - x) * (1.0 + x))
    wc = w - 2.5
    wt = torch.sqrt(w) - 3.0
    pc = torch.full_like(x, _ERFINV_CENTRAL[0])
    pt = torch.full_like(x, _ERFINV_TAIL[0])
    for cc, ct in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        pc = cc + pc * wc
        pt = ct + pt * wt
    return torch.where(w < 5.0, pc, pt) * x


def normal_from_bits(h: torch.Tensor) -> torch.Tensor:
    """The kernel contract's N(0,1) sample of a hash, float32.

    ``u24`` is bits 28..51 of the hash and ``x = 2u - 1`` for
    ``u = (u24 + 1/2) / 2^24`` is formed exactly in int32 first:
    ``u24 + 0.5`` in float32 rounds to 2^24 when ``u24 = 2^24 - 1`` and
    erfinv(1) is inf."""
    u24 = (_lshr(h, 28) & 0xFFFFFF).to(torch.int32)
    v = 2 * u24 - (2 ** 24 - 1)
    x = v.to(torch.float32) * _INV_2_24
    return _SQRT2_F32 * _erfinv_f32(x)


# ---------------------------------------------------------------------------
# sparse-sign rows
# ---------------------------------------------------------------------------

def sign_from_bits(h: torch.Tensor) -> torch.Tensor:
    """±1 (int64) from hash bit 52.  The mask makes the arithmetic int64
    shift as good as a logical one."""
    return ((h >> 52) & 1) * 2 - 1


def swap_position(h: torch.Tensor, m: int, j: int) -> torch.Tensor:
    """The exact integer ``floor(u52·m / 2^52) + j`` of one Fisher–Yates
    draw, ``u52`` the low 52 hash bits.

    ``u52·m`` overflows int64 for ``m > 2^11``, so the 52 bits are split
    into their top 20 and low 32: ``u52·m = (hi20·m + (lo32·m >> 32))·2^32
    + …`` and the floor is that sum ``>> 20``.  Each product stays below
    2^63 for any ``m < 2^31``."""
    m = int(m)
    if not 0 < m < 1 << 31:
        raise ValueError(f"swap range {m} outside (0, 2^31)")
    u52 = h & _MASK52
    hi20 = u52 >> 32
    lo32 = u52 & 0xFFFFFFFF
    return ((hi20 * m + ((lo32 * m) >> 32)) >> 20) + int(j)


def _shuffle_rows(out: torch.Tensor, positions) -> torch.Tensor:
    """The Fisher–Yates pass on (rank, N) ``out``: step ``j`` swaps row
    ``j`` with row ``positions(j)[n]`` in every column ``n``."""
    j = 0
    for rp in positions:
        rp = rp[None, :]
        vj = out[j:j + 1].clone()
        out[j:j + 1] = out.gather(0, rp)
        out.scatter_(0, rp, vj)
        j += 1
    return out


def sparse_sign_from_bits(h: torch.Tensor, rank: int, rank_min: int,
                          rank_max: int) -> torch.Tensor:
    """Kernel-contract sparse-sign rows from the (nnz, N) hashes of columns
    ``[0, nnz)``: (rank_max - rank_min, N) float32 in {-1, 0, +1}."""
    nnz, N = h.shape
    if nnz > rank:
        raise ValueError(f"{nnz} non-zeros per row > rank {rank}")
    out = torch.zeros((rank, N), dtype=torch.float32, device=h.device)
    out[:nnz] = sign_from_bits(h).to(torch.float32)
    _shuffle_rows(out, (swap_position(h[j], rank - j, j)
                        for j in range(nnz)))
    return out[rank_min:rank_max]


def inds_to_sparse_sign(indices: torch.Tensor, shape: Sequence[int],
                        rank: int, rank_min: int, rank_max: int,
                        nnz_per_row: int, seed: int,
                        dtype=torch.float64) -> torch.Tensor:
    """Parity-path sparse-sign DRM entries at (d, N) multi-indices:
    (N, rank_max - rank_min), exactly ``nnz_per_row`` ±1 per full row.  The
    swap positions are the float64 products of the JAX package's
    ``inds_to_sparse_sign``, truncated."""
    rank, nnz = int(rank), int(nnz_per_row)
    if nnz > rank:
        raise ValueError(f"{nnz} non-zeros per row > rank {rank}")
    flat = flat_index(indices, shape)
    h = _hash_bits(flat, 0, nnz, int(seed)).T.contiguous()  # (nnz, N)
    u = uniform_from_bits(h)
    out = torch.zeros((rank, flat.shape[0]), dtype=torch.int64,
                      device=flat.device)
    out[:nnz] = sign_from_bits(h)
    _shuffle_rows(out, ((u[j] * (rank - j) + j).to(torch.int64)
                        for j in range(nnz)))
    return out[rank_min:rank_max].T.to(dtype)


# ---------------------------------------------------------------------------
# Dense helpers
# ---------------------------------------------------------------------------

def lazy_gaussian_matrix(n_rows: int, shape: Sequence[int], rank_min: int,
                         rank_max: int, seed: int, backend: str = "torch",
                         device=None):
    """The full lazy-Gaussian DRM block of flat rows [0, n_rows), (n_rows,
    rank_max - rank_min) float64: ``inds_to_normal`` on the index grid of
    ``shape`` unraveled column-major.  ``backend="torch"`` gives a tensor
    on ``device`` (default: the package default), ``"np"`` a numpy array
    (scipy's ``ndtri``); the JAX package's ``"jax"`` has no counterpart
    here."""
    if backend == "np":
        import scipy.special

        h = _hash_bits_np(np.arange(n_rows, dtype=np.uint64), int(rank_min),
                          int(rank_max), int(seed))
        return scipy.special.ndtri(_uniform_from_bits_np(h))
    if backend != "torch":
        raise ValueError(f"lazy_gaussian_matrix: backend {backend!r}; the "
                         f"port has 'torch' and 'np'")
    from tt_sketch_torch.config import resolve_device

    flat = torch.arange(int(n_rows), dtype=torch.int64,
                        device=resolve_device(device))
    h = _hash_bits(flat, int(rank_min), int(rank_max), int(seed))
    return torch.special.ndtri(uniform_from_bits(h))
