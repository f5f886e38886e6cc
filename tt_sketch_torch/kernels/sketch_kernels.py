"""Ψ/Ω sketch contractions for dense and TT input.

Ω_μ = Y_μᵀ X^{<μ>} Z_μ (small matrix) and Ψ_μ = Y_{μ-1}ᵀ X^{(μ)} Z_μ
(order-3 core), from the DRMs' per-mode contraction outputs.  Counterpart
of the dense and TT functions of ``tt_sketch_tpu/kernels/sketch_kernels.py``;
the sparse, CP and Tucker functions come with later slices.
"""
from __future__ import annotations

import torch

from tt_sketch_torch.utils import matricize


# -- dense -------------------------------------------------------------------

def sketch_omega_dense(left_sketch, right_sketch, *, tensor, mu, **kwargs):
    X_mat = matricize(tensor.data, tuple(range(mu + 1)), mat_shape=True)
    return left_sketch @ X_mat @ right_sketch.T


def sketch_psi_dense(left_sketch, right_sketch, *, tensor, mu, **kwargs):
    ndim = tensor.ndim
    data = tensor.data
    if left_sketch is None:
        mat = matricize(data, 0, mat_shape=True)
        Psi = mat @ right_sketch.T
        return Psi[None, :, :]
    if right_sketch is None:
        mat = matricize(data, ndim - 1, mat_shape=True).T
        Psi = left_sketch @ mat
        return Psi[:, :, None]
    ord3 = matricize(data, tuple(range(mu + 1)), mat_shape=False)
    left_dim = 1
    for s in ord3.shape[:mu]:
        left_dim *= s
    ord3 = ord3.reshape(left_dim, ord3.shape[mu], ord3.shape[mu + 1])
    tmp = torch.einsum("ij,jkl->ikl", left_sketch, ord3)
    return torch.einsum("ikl,ml->ikm", tmp, right_sketch)


# -- tensor train ------------------------------------------------------------

def sketch_omega_tt(left_sketch, right_sketch, **kwargs):
    return left_sketch.T @ right_sketch


def sketch_psi_tt(left_sketch, right_sketch, *, tensor, mu, **kwargs):
    core = tensor.cores[mu]
    if left_sketch is None:
        return torch.einsum("ijk,kl->ijl", core, right_sketch)
    if right_sketch is None:
        return torch.einsum("ij,jkl->ikl", left_sketch.T, core)
    tmp = torch.einsum("ij,jkl->ikl", left_sketch.T, core)
    return torch.einsum("ikl,lm->ikm", tmp, right_sketch)
