"""Parametric-PDE linear maps, the "cookie problem" family (counterpart of
``tt_sketch_tpu/solvers/parametric.py``).

``CookieMap``/``prepare_cookie_problem`` take externally supplied matrices;
``prepare_synthetic_cookie_problem`` makes a stand-in with the same
structure: a base stiffness matrix on mode 0 plus per-"cookie" matrices
whose strength is modulated by a coefficient axis (one tensor mode per
cookie).  The matrices are drawn with numpy exactly as the JAX package
draws them, so one seed gives the same problem in both packages.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tt_sketch_torch.config import DEFAULT_DTYPE, resolve_device
from tt_sketch_torch.formats.tensor_train import TensorTrain
from tt_sketch_torch.solvers.tt_gmres import (
    TTLinearMap,
    TTLinearMapSum,
    TTPrecond,
    _on_device,
)


class CookieMap(TTLinearMap):
    """Applies ``A`` on mode 0 and scales mode ``mode`` by ``coeffs``
    (``tt_sketch_tpu/solvers/parametric.py:22-46``); numpy or torch ``A``
    and ``coeffs`` move to ``device``."""

    def __init__(self, A, mode: int, shape: Tuple[int, ...], coeffs,
                 device=None) -> None:
        self.A = _on_device(A, device)
        self.mode = mode
        self.in_shape = tuple(shape)
        self.out_shape = tuple(shape)
        self.coeffs = _on_device(coeffs, device)

    def __call__(self, other: TensorTrain) -> TensorTrain:
        new_cores = list(other.cores)
        new_cores[0] = torch.einsum("ijk,jl->ilk", new_cores[0], self.A)
        if self.mode != 0:
            new_cores[self.mode] = torch.einsum(
                "ijk,j->ijk", new_cores[self.mode], self.coeffs
            )
        return TensorTrain(new_cores)


def _laplacian_1d(n: int) -> np.ndarray:
    A = 2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    return A * (n + 1) ** 2 / 100.0


def _cookie_patch(n: int, k: int, num_cookies: int, rng) -> np.ndarray:
    """SPD matrix supported on a contiguous index patch (a 'cookie')."""
    lo = (k * n) // num_cookies
    hi = ((k + 1) * n) // num_cookies
    B = rng.standard_normal((hi - lo, max(2, (hi - lo) // 2)))
    patch = B @ B.T / B.shape[1] + 0.5 * np.eye(hi - lo)
    A = np.zeros((n, n))
    A[lo:hi, lo:hi] = patch
    return A


def prepare_cookie_problem(
    A_list: List[np.ndarray],
    b: np.ndarray,
    num_coeffs: int,
    coeff_range: Tuple[float, float] = (0.0, 10.0),
    device=None,
) -> Tuple[TTLinearMapSum, TensorTrain, TTPrecond]:
    """The map-sum, right-hand-side TT and mean-coefficient preconditioner
    from externally supplied numpy matrices (``A_list[0]`` is the base
    operator; each further matrix is one cookie), on ``device``
    (``tt_sketch_tpu/solvers/parametric.py:67-102``)."""
    device = resolve_device(device)
    shape = (A_list[0].shape[0],) + (num_coeffs,) * (len(A_list) - 1)

    A_precond_list = []
    coeffs_list = []
    for mu, A in enumerate(A_list):
        if mu == 0:
            coeffs = np.ones(A.shape[0])
        else:
            coeffs = np.linspace(*coeff_range, num_coeffs)
        A_precond_list.append(np.asarray(A) * float(np.mean(coeffs)))
        coeffs_list.append(coeffs)

    precond_map = TTPrecond(np.sum(A_precond_list, axis=0), shape, mode=0,
                            device=device)
    map_sum = TTLinearMapSum([
        CookieMap(A, mu, shape, coeffs, device=device)
        for mu, (A, coeffs) in enumerate(zip(A_list, coeffs_list))
    ])

    B_cores = [_on_device(b, device).reshape(1, -1, 1)]
    for n in shape[1:]:
        B_cores.append(torch.ones((1, n, 1), dtype=DEFAULT_DTYPE,
                                  device=device))
    return map_sum, TensorTrain(B_cores), precond_map


def prepare_synthetic_cookie_problem(
    num_coeffs: int = 10,
    num_cookies: int = 4,
    n: int = 60,
    seed: Optional[int] = 0,
    device=None,
) -> Tuple[TTLinearMapSum, TensorTrain, TTPrecond]:
    """Synthetic stand-in for the htucker cookie data: 1D Laplacian base
    operator + ``num_cookies`` SPD patch matrices with coefficient modes
    (``tt_sketch_tpu/solvers/parametric.py:105-118``)."""
    rng = np.random.default_rng(seed)
    A_list = [_laplacian_1d(n)]
    for k in range(num_cookies):
        A_list.append(_cookie_patch(n, k, num_cookies, rng))
    return prepare_cookie_problem(A_list, np.ones(n), num_coeffs,
                                  device=device)
