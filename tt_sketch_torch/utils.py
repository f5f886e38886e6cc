"""Numeric utilities: matricization, TT-rank processing, pinv products,
the deterministic host RNG and synthetic test tensors.

Counterpart of ``tt_sketch_tpu/utils.py``.  ``random_normal`` draws from the
same NumPy PCG64 stream, so DRM cores and random TTs are bit-identical to
the JAX package's for equal seeds and dtypes.  The synthetic tensors
(``tt_sketch_tpu/utils.py:191-228``) are made with numpy on the host, as
the JAX package makes them, then moved to ``device``.
"""
from __future__ import annotations

from functools import reduce
from operator import mul
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.config import DEFAULT_DTYPE, resolve_device

TTRank = Union[int, Tuple[int, ...]]


# ---------------------------------------------------------------------------
# Matricization
# ---------------------------------------------------------------------------

def matricize(A: torch.Tensor, mode: Union[int, Sequence[int]],
              mat_shape: bool = False) -> torch.Tensor:
    """Unfold tensor ``A`` with the modes in ``mode`` mapped to rows.

    If ``mode`` is an int the result is a matrix.  If it is a sequence, the
    result keeps the row modes separate unless ``mat_shape=True``.
    """
    mode = (mode,) if isinstance(mode, int) else tuple(mode)
    perm = mode + tuple(i for i in range(A.ndim) if i not in mode)
    A = A.permute(perm)
    right = int(np.prod(A.shape[len(mode):], dtype=np.int64))
    if mat_shape:
        left: Tuple[int, ...] = (
            int(np.prod(A.shape[: len(mode)], dtype=np.int64)),
        )
    else:
        left = tuple(A.shape[: len(mode)])
    return A.reshape(left + (right,))


def dematricize(A: torch.Tensor, mode: int,
                shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of ``matricize`` for a single-mode unfolding."""
    current = (A.shape[0],) + tuple(s for i, s in enumerate(shape) if i != mode)
    A = A.reshape(current)
    perm = list(range(1, len(shape)))
    perm = perm[:mode] + [0] + perm[mode:]
    return A.permute(perm)


# ---------------------------------------------------------------------------
# Pseudo-inverse products
# ---------------------------------------------------------------------------

@profiling.spanned("tt.lstsq")
def _lstsq(A: torch.Tensor, B: torch.Tensor,
           rcond: Optional[float] = None) -> torch.Tensor:
    """Minimum-norm least squares ``argmin_x |A x - B|`` by truncated SVD,
    over any leading batch dimensions of ``A`` (..., m, n) and ``B``
    (..., m, k).

    Singular values below ``rcond·σ_max`` of their own matrix are dropped,
    with LAPACK's default ``rcond = eps(dtype)·max(m, n)`` (the CPU rule of
    the JAX package, ``kernels/accurate_linalg._default_rcond``).
    ``torch.linalg.lstsq`` is not used: on CUDA its only driver (``gels``)
    assumes full rank and ignores ``rcond``, and the exact-recovery regime
    makes Ω rank-deficient on purpose.
    """
    m, n = A.shape[-2:]
    if rcond is None:
        rcond = torch.finfo(A.dtype).eps * max(m, n)
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    keep = s >= rcond * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return Vh.mT @ (s_inv[..., :, None] * (U.mT @ B))


def right_mul_pinv(A: torch.Tensor, B: torch.Tensor,
                   rcond: Optional[float] = None) -> torch.Tensor:
    """Numerically stable ``A @ pinv(B)`` via least squares (batched over
    leading dimensions, as ``_lstsq``)."""
    return _lstsq(B.mT, A.mT, rcond=rcond).mT


def left_mul_pinv(A: torch.Tensor, B: torch.Tensor,
                  rcond: Optional[float] = None) -> torch.Tensor:
    """Numerically stable ``pinv(A) @ B`` via least squares."""
    return _lstsq(A, B, rcond=rcond)


def projector(X: torch.Tensor, Y: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    r"""Oblique projector :math:`P_{X,Y} = X (Y^T X)^+ Y^T`
    (``tt_sketch_tpu/utils.py:93-97``)."""
    if Y is None:
        Y = X
    return X @ torch.linalg.pinv(Y.mT @ X) @ Y.mT


# ---------------------------------------------------------------------------
# TT-rank processing (pure Python)
# ---------------------------------------------------------------------------

def trim_ranks(
    dims: Tuple[int, ...], ranks: Tuple[int, ...]
) -> Tuple[int, ...]:
    """Clamp TT-ranks to the largest values achievable losslessly.

    Rank ``r_i`` can never exceed the product of mode sizes on either side of
    edge ``i``, nor ``d_i * r_{i-1}`` / ``d_{i+1} * r_{i+1}``.
    """
    ranks_trimmed = list(ranks)
    for i, r in enumerate(ranks_trimmed):
        dim_left = reduce(mul, dims[: i + 1], 1)
        dim_right = reduce(mul, dims[i + 1:], 1)
        ranks_trimmed[i] = min(r, dim_left, dim_right)
    ranks_trimmed = [1] + ranks_trimmed + [1]
    for _ in range(100):
        changed = False
        for i, d in enumerate(dims):
            if ranks_trimmed[i + 1] > ranks_trimmed[i] * d:
                changed = True
                ranks_trimmed[i + 1] = ranks_trimmed[i] * d
            if ranks_trimmed[i] > d * ranks_trimmed[i + 1]:
                changed = True
                ranks_trimmed[i] = d * ranks_trimmed[i + 1]
        if not changed:
            break
    return tuple(ranks_trimmed[1:-1])


def process_tt_rank(
    rank: TTRank, shape: Tuple[int, ...], trim: bool
) -> Tuple[int, ...]:
    """Normalize a TT-rank spec to a tuple of length ``len(shape)-1``."""
    try:
        rank_tuple = tuple(int(r) for r in rank)  # type: ignore[union-attr]
    except TypeError:
        rank_tuple = (int(rank),) * (len(shape) - 1)  # type: ignore[arg-type]
    if len(rank_tuple) != len(shape) - 1:
        raise ValueError(
            f"TT-rank {rank_tuple} doesn't have the right number of elements "
            f"for shape {shape}"
        )
    if trim:
        rank_tuple = trim_ranks(tuple(shape), rank_tuple)
    return rank_tuple


# ---------------------------------------------------------------------------
# Deterministic RNG
# ---------------------------------------------------------------------------

def random_normal(shape, seed: Optional[int] = None, dtype=None,
                  device=None) -> torch.Tensor:
    """Standard-normal tensor drawn on the host from one PCG64 stream
    (``default_rng(SeedSequence(seed))``), then moved to ``device``.

    Same stream and same rounding as the JAX package's ``random_normal``,
    so equal seeds give bit-identical values.
    """
    dtype = dtype or DEFAULT_DTYPE
    device = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    vals = rng.standard_normal(size=int(np.prod(shape)))
    return torch.from_numpy(vals.reshape(shape)).to(device=device, dtype=dtype)


def reference_random_normal(shape, seed: Optional[int],
                            threads: int) -> np.ndarray:
    """Bit-reproduce the reference's ``MultithreadedRNG`` for a pinned thread
    count (``tt_sketch_tpu/utils.py:168-186``): the flat array is filled in
    ``threads`` contiguous chunks of size ``ceil(n/threads)``, chunk ``i``
    drawn from ``SeedSequence(seed).spawn(threads)[i]``.  Returns numpy, as
    the JAX package's does.
    """
    n = int(np.prod(shape))
    seq = np.random.SeedSequence(seed)
    gens = [np.random.default_rng(s) for s in seq.spawn(threads)]
    values = np.empty(n)
    step = int(np.ceil(n / threads))
    for i, g in enumerate(gens):
        first, last = i * step, min((i + 1) * step, n)
        if first >= n:
            break
        g.standard_normal(out=values[first:last])
    return values.reshape(shape)


# ---------------------------------------------------------------------------
# Synthetic tensors (values made with numpy on the host)
# ---------------------------------------------------------------------------

def _from_host(values: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(values).to(device=resolve_device(device),
                                       dtype=dtype or DEFAULT_DTYPE)


def hilbert_tensor(n_dims: int, size: int, dtype=None,
                   device=None) -> torch.Tensor:
    """Hilbert tensor ``X[i1..id] = 1 / (i1 + ... + id + 1)``."""
    grid = np.indices((size,) * n_dims).sum(axis=0)
    return _from_host(1.0 / (grid + 1), dtype, device)


def sqrt_tensor(shape: Tuple[int, ...], a=-0.2, b=2, dtype=None,
                device=None) -> torch.Tensor:
    """``sqrt(|sum of grid values|)`` tensor, normalized to unit norm."""
    vals = [np.linspace(a, b, s) for s in shape]
    grid = np.stack(np.meshgrid(*vals, indexing="ij"))
    X = np.sqrt(np.abs(np.sum(grid, axis=0)))
    X /= np.linalg.norm(X)
    return _from_host(X, dtype, device)


def power_decay_tensor(
    shape: Tuple[int, ...], pow: float = 2.0, seed=None, dtype=None,
    device=None,
) -> torch.Tensor:
    """Random tensor whose every unfolding has power-law singular values.

    (The reference's version has a missing-import bug, SURVEY.md §2.4;
    this is the intended behavior, as in the JAX package.)
    """
    seq = np.random.SeedSequence(seed)
    A_seed = seq.generate_state(1)[0]
    rng = np.random.default_rng(np.random.SeedSequence(int(A_seed)))
    A = torch.from_numpy(rng.standard_normal(size=shape))
    for mode in range(len(shape)):
        A_mat = matricize(A, mode).numpy()
        U, S, V = np.linalg.svd(A_mat, full_matrices=False)
        S /= S[0]
        S *= 1 / np.arange(1, len(S) + 1) ** pow
        A = dematricize(torch.from_numpy(U @ np.diag(S) @ V), mode, shape)
    return _from_host(A.contiguous().numpy(), dtype, device)
