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
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.config import DEFAULT_DTYPE, resolve_device
from tt_sketch_torch.kernels.jacobi_svd import jacobi_fits, jacobi_svd

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

def _svd(A: torch.Tensor):
    """``(U, s, Vh)`` of ``A`` (..., m, n) as ``torch.linalg.svd(A,
    full_matrices=False)`` returns them.

    A CUDA tensor whose matrices ``jacobi_fits`` takes the batched Jacobi
    kernel (``kernels/jacobi_svd``): one launch, no host sync.  A CPU tensor
    takes ``torch.linalg.svd``, and so does anything else on a card, in the
    span ``tt.lstsq_svd_fallback``, counted as ``fallbacks.lstsq_svd`` (on
    CUDA that call checks its info on the host: a sync)."""
    if A.device.type == "cpu":
        return torch.linalg.svd(A, full_matrices=False)
    if A.device.type == "cuda" and jacobi_fits(*A.shape[-2:], A.dtype):
        return jacobi_svd(A)
    profiling.count("fallbacks.lstsq_svd")
    with profiling.span("tt.lstsq_svd_fallback"):
        return torch.linalg.svd(A, full_matrices=False)


def _inverted(s: torch.Tensor, m: int, n: int,
              rcond: Optional[float] = None) -> torch.Tensor:
    """``1 / s`` where ``s >= rcond·σ_max`` of its own matrix (the first of
    its row: ``s`` descends), else 0; LAPACK's default ``rcond =
    eps(dtype)·max(m, n)`` for m x n matrices (the CPU rule of the JAX
    package, ``kernels/accurate_linalg._default_rcond``)."""
    if rcond is None:
        rcond = torch.finfo(s.dtype).eps * max(m, n)
    keep = s >= rcond * s[..., :1]
    return torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))


def _solve(U: torch.Tensor, s_inv: torch.Tensor, Vh: torch.Tensor,
           B: torch.Tensor) -> torch.Tensor:
    """``V diag(s_inv) U^T B`` of a factored ``A = U diag(s) Vh``."""
    return Vh.mT @ (s_inv[..., :, None] * (U.mT @ B))


@profiling.spanned("tt.lstsq")
def _lstsq(A: torch.Tensor, B: torch.Tensor,
           rcond: Optional[float] = None) -> torch.Tensor:
    """Minimum-norm least squares ``argmin_x |A x - B|`` by truncated SVD,
    over any leading batch dimensions of ``A`` (..., m, n) and ``B``
    (..., m, k).

    Singular values below ``rcond·σ_max`` of their own matrix are dropped
    (``_inverted``).  ``torch.linalg.lstsq`` is not used: on CUDA its only
    driver (``gels``) assumes full rank and ignores ``rcond``, and the
    exact-recovery regime makes Ω rank-deficient on purpose.  The SVD is
    ``_svd``'s: on a card the Jacobi kernel where it fits, so that a
    non-finite ``A`` gives a non-finite solution (as the JAX package's
    Jacobi path gives) where ``torch.linalg.svd`` raised; on the CPU
    ``torch.linalg.svd``, as before.
    """
    U, s, Vh = _svd(A)
    return _solve(U, _inverted(s, *A.shape[-2:], rcond), Vh, B)


def lstsq_each(systems: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               rcond: Optional[float] = None) -> List[torch.Tensor]:
    """``_lstsq(A, B, rcond)`` of each ``(A, B)`` of ``systems``.

    The A's of one shape, dtype and device are stacked and factored by one
    ``_svd`` call (on a card one Jacobi launch for all the Ω of a
    recovery), then each system is solved with ``_lstsq``'s rule and
    products.  On the CPU the batched LAPACK SVD gives each matrix the bits
    of its own call, so the solutions are ``_lstsq``'s, bit for bit."""
    groups: Dict[tuple, List[int]] = {}
    for i, (A, _) in enumerate(systems):
        groups.setdefault((tuple(A.shape), A.dtype, A.device), []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(systems)
    with profiling.span("tt.lstsq"):
        for (shape, _, _), members in groups.items():
            U, s, Vh = _svd(torch.stack([systems[i][0] for i in members]))
            s_inv = _inverted(s, *shape[-2:], rcond)
            for k, i in enumerate(members):
                out[i] = _solve(U[k], s_inv[k], Vh[k], systems[i][1])
    return out


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
