"""Matrices for the Jacobi SVD tests (``test_torch_jacobi_svd.py`` on the
CPU, ``test_torch_jacobi_svd_card.py`` on a card), made with numpy in
float64 from fixed seeds.  Imports neither JAX nor a card.

The shapes are the recovery's: FROSTT-uber's Ω (20 x 40, so ``_lstsq``
factors 40 x 20) and the dense stream's (32 x 64: 64 x 32), three a
request; the uniform engine's 30 x 30 float64 edges make the batch case.
"""
import numpy as np

SHAPES = [(3, 40, 20), (3, 64, 32)]
KINDS = ["well", "cond_1e6", "rank_noise", "zero", "wide"]


def matrices(kind: str, shape, eps: float, seed: int = 0) -> np.ndarray:
    """(b, m, n) float64 matrices of ``kind`` (``wide``: (b, n, m)):

    - ``well``: standard normal entries;
    - ``cond_1e6``: ``U diag(logspace(0, -6, n)) V^T``, U and V random
      orthonormal;
    - ``rank_noise``: a product of rank n // 3 (the exact-recovery regime's
      rank-deficient Ω) plus noise of ``eps`` times its largest entry (the
      rounding of the working dtype);
    - ``zero``: zeros;
    - ``wide``: standard normal, transposed shape.
    """
    b, m, n = shape
    rng = np.random.default_rng(seed)
    if kind == "well":
        return rng.standard_normal((b, m, n))
    if kind == "wide":
        return rng.standard_normal((b, n, m))
    if kind == "zero":
        return np.zeros((b, m, n))
    if kind == "cond_1e6":
        U = np.linalg.qr(rng.standard_normal((b, m, n)))[0]
        V = np.linalg.qr(rng.standard_normal((b, n, n)))[0]
        return (U * np.logspace(0, -6, n)) @ V.transpose(0, 2, 1)
    if kind == "rank_noise":
        r = max(1, n // 3)
        low = rng.standard_normal((b, m, r)) @ rng.standard_normal((b, r, n))
        big = np.abs(low).max(axis=(1, 2), keepdims=True)
        return low + eps * big * rng.standard_normal((b, m, n))
    raise ValueError(kind)


def rhs(A: np.ndarray, k: int = 5, seed: int = 1) -> np.ndarray:
    """Right-hand sides (b, m, k) for ``A`` (b, m, n)."""
    return np.random.default_rng(seed).standard_normal(A.shape[:2] + (k,))


def truncated_solve(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """numpy's minimum-norm solve per matrix, singular values at or below
    ``eps(float64)·max(m, n)·σ_max`` dropped (``np.linalg.lstsq``)."""
    m, n = A.shape[-2:]
    rcond = np.finfo(np.float64).eps * max(m, n)
    return np.stack([np.linalg.lstsq(a, b_, rcond=rcond)[0]
                     for a, b_ in zip(A, B)])
