"""Synthetic benchmark problems, one builder per experiment (counterpart of
``tt_sketch_tpu/experiments/problems.py``).

Every builder takes explicit seeds and gives the JAX package's tensor for
equal arguments (host numpy draws), on ``device`` (default: the package
default).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tt_sketch_torch.config import resolve_device
from tt_sketch_torch.engine import uniform as uni
from tt_sketch_torch.formats import (
    CPTensor,
    DenseTensor,
    SparseTensor,
    TensorSum,
    TensorTrain,
)
from tt_sketch_torch.utils import (
    hilbert_tensor,
    process_tt_rank,
    random_normal,
    sqrt_tensor,
)


def hilbert_problem(n_dims: int = 7, size: int = 5,
                    device=None) -> SparseTensor:
    """7-dim size-5 Hilbert tensor as sparse."""
    return DenseTensor(hilbert_tensor(n_dims, size,
                                      device=device)).to_sparse()


def sqrt_problem(
    n_dims: int = 5, dim: int = 10, a: float = -0.2, b: float = 2.0,
    device=None,
) -> SparseTensor:
    """sqrt-of-sum tensor of shape dim^n_dims as sparse."""
    return DenseTensor(sqrt_tensor((dim,) * n_dims, a=a, b=b,
                                   device=device)).to_sparse()


def tt_sum_problem(
    n_dims: int = 5,
    dim: int = 10,
    tt_rank: int = 3,
    num_tts: int = 20,
    coeff_decay: float = -20.0,
    seed: int = 179,
    device=None,
) -> TensorSum:
    """Sum of ``num_tts`` random rank-``tt_rank`` TTs with log-decaying
    coefficients 1 → 10^coeff_decay."""
    shape = (dim,) * n_dims
    coeffs = np.logspace(0.0, coeff_decay, num_tts)
    summands = [
        TensorTrain.random(shape, rank=tt_rank, seed=seed + i,
                           device=device) * float(c)
        for i, c in enumerate(coeffs)
    ]
    return TensorSum(summands)


def tt_plus_sparse_problem(
    n_dims: int = 5,
    dim: int = 10,
    tt_rank: int = 5,
    nnz: int = 100,
    entry_decay: Tuple[float, float] = (-3.0, -20.0),
    seed: int = 179,
    device=None,
) -> TensorSum:
    """Rank-5 TT plus ``nnz`` sparse outliers with log-decaying
    magnitudes."""
    shape = (dim,) * n_dims
    tensor_tt = TensorTrain.random(shape, rank=tt_rank, seed=seed,
                                   device=device)
    rng = np.random.default_rng(seed)
    tot_dim = int(np.prod(shape))
    inds_dense = rng.choice(tot_dim, nnz, replace=False)
    inds = np.stack(np.unravel_index(inds_dense, shape))
    entries = rng.standard_normal(nnz) * np.logspace(
        entry_decay[0], entry_decay[1], nnz
    )
    tensor_sparse = SparseTensor(shape, inds, entries, device=device)
    return tensor_sparse + tensor_tt


def cp_problem(
    n_dims: int = 5, dim: int = 10, cp_rank: int = 100, seed: int = 179,
    device=None,
) -> CPTensor:
    """Rank-100 CP tensor with component norms 1/k^5."""
    shape = (dim,) * n_dims
    rng = np.random.default_rng(seed)
    cp_norms = 1.0 / np.arange(1, cp_rank + 1) ** 5
    cores = []
    for n in shape:
        core = rng.standard_normal((n, cp_rank))
        core = core / np.linalg.norm(core, axis=0)
        cores.append(core)
    cores[0] = cp_norms * cores[0]
    device = resolve_device(device)
    return CPTensor([torch.from_numpy(c).to(device) for c in cores])


def exp_decay_uniform_problem(
    order: int, dim: int = 30, rank: int = 30, seed: int = 179, device=None
):
    """Order-scaling test tensor: a uniform TT with exp-decaying unfolding
    spectra, stacked for the uniform engine."""
    return uni.uniform_exp_decay_tt(order, dim, rank, seed, device=device)


def dense_random_problem(
    n_dims: int = 5, dim: int = 100, seed: int = 179, dtype=None,
    device=None,
) -> DenseTensor:
    """Large dense random tensor for wall-time benchmarks."""
    return DenseTensor.random((dim,) * n_dims, seed=seed, dtype=dtype,
                              device=device)


def exp_decay_tt_problem(
    n_dims: int,
    dim: int = 5,
    tt_rank: int = 10,
    seed: int = 179,
    min_svdval: float = -5.0,
    device=None,
) -> TensorTrain:
    """Exp-decay-spectrum TT for the Gaussian-DRM order-scaling sweep: the
    orthogonal random TT of ``TensorTrain.random(..., orthog=True,
    trim=True)`` whose per-core unfolding spectra are replaced by
    ``logspace(0, min_svdval) * sqrt(min_dim)``, moved to ``device`` and
    re-orthogonalized there.

    An orthogonal core's singular values are all 1, so its SVD's vectors
    follow the last bit of its QR: the QRs and SVDs run on the host with
    numpy, whose LAPACK gives the JAX package's bits."""
    shape = (dim,) * n_dims
    ranks = (1,) + tuple(process_tt_rank(tt_rank, shape, trim=True)) + (1,)
    seeds = np.random.SeedSequence(seed).generate_state(n_dims)
    device = resolve_device(device)
    new_cores = []
    for i, n in enumerate(shape):
        r1, r2 = ranks[i], ranks[i + 1]
        C = random_normal((r1 * n, r2), seed=int(seeds[i]),
                          device="cpu").numpy()
        C = np.linalg.qr(C)[0] if i < n_dims - 1 else C / np.sqrt(r1 * n)
        left_shape = (r1 * n, r2)
        right_shape = (r1, n * r2)
        mat_shape = (
            left_shape if min(left_shape) > min(right_shape) else right_shape
        )
        U, S, Vt = np.linalg.svd(C.reshape(mat_shape), full_matrices=False)
        S_new = np.logspace(0.0, min_svdval, len(S)) * np.sqrt(min(mat_shape))
        new_cores.append(
            torch.from_numpy((U * S_new) @ Vt).reshape(r1, n, r2).to(device))
    return TensorTrain(new_cores).orthogonalize()


def timings_vs_error_problem(
    n_dims: int = 5,
    dim: int = 1000,
    tt_rank: int = 100,
    num_tts: int = 10,
    seed: int = 179,
    device=None,
) -> TensorSum:
    """Sum of 10 random rank-100 TTs, shape (1000,)^5 with coefficients
    decaying 1 → 1e-10."""
    return tt_sum_problem(
        n_dims=n_dims,
        dim=dim,
        tt_rank=tt_rank,
        num_tts=num_tts,
        coeff_decay=-10.0,
        seed=seed,
        device=device,
    )
