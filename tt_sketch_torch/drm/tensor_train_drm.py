"""Tensor-train DRM: sketches with partial contractions of a fixed random TT.

Counterpart of ``tt_sketch_tpu/drm/tensor_train_drm.py`` for sparse,
dense, TT, CP and Tucker input.  The per-mode chain *step* functions are exported because the
orthogonal/HMT sketches reuse them with the just-orthogonalized Ψ cores in
place of random cores.  Chain-state conventions (state after absorbing
cores 0..mu):

- sparse: ``(nnz, r)`` rows of the partial contraction at the nonzeros
  (``chain_step_sparse``); the sketches keep it transposed, ``(r, nnz)``
  (``chain_step_sparse_t``), the layout the Ψ kernels consume
- tt:     ``(tensor_rank, r)``
- dense:  ``(prod(shape[:mu+1]), r)`` — explicit prefix contraction
- cp:     ``(cp_rank, r)``
- tucker: ``(prod(tucker_rank[:mu+1]), r)``
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from tt_sketch_torch.drm.base import (
    CanSlice,
    CansketchCP,
    CansketchDense,
    CansketchSparse,
    CansketchTT,
    CansketchTucker,
    handle_transpose,
)
from tt_sketch_torch.formats.tensor_train import TensorTrain
from tt_sketch_torch.kernels.chain_step import (
    KERNEL_DTYPES,
    chain_step_t,
    chain_step_t_reference,
)


def chain_step_sparse_t(state_t, core, indices_mu):
    """Transposed sparse chain step: the ``(r2, nnz)`` state from the
    ``(r1, nnz)`` one (None on the first mode),
    ``out[k, j] = Σ_i state_t[i, j]·core[i, idx[j], k]``.

    float32/bfloat16 go through ``kernels.chain_step.chain_step_t`` whatever
    the mode size, the number of nonzeros or the ranks (the JAX package
    gates its kernel to ``n ≤ 4096`` and ``nnz ≥ 4096``); float64 takes the
    plain einsum."""
    if core.dtype in KERNEL_DTYPES:
        return chain_step_t(state_t, core, indices_mu)
    return chain_step_t_reference(state_t, core, indices_mu)


def chain_step_sparse(state, core, indices_mu):
    """Absorb one TT core at the sparse tensor's μ-th index row: the
    ``(nnz, r2)`` state from the ``(nnz, r1)`` one (None on the first
    mode).  The same summands as ``chain_step_sparse_t``, transposed."""
    state_t = None if state is None else state.T
    return chain_step_sparse_t(state_t, core, indices_mu).T


def chain_step_tt(state, core, tensor_core):
    if state is None:
        return torch.einsum("ijk,ijl->kl", tensor_core, core)
    tmp = torch.einsum("ij,ikl->jkl", state, tensor_core)  # (r_drm, n, r_t2)
    return torch.einsum("jkl,jkm->lm", tmp, core)


def chain_step_cp(state, core, cp_factor):
    if state is None:
        return torch.einsum("ij,lik->jk", cp_factor, core)
    return torch.einsum("ij,ki,jkl->il", state, cp_factor, core)


def chain_step_tucker(state, core, tucker_factor):
    reduced = torch.einsum("jkl,km->jml", core, tucker_factor.T)
    if state is None:
        return reduced.reshape(-1, reduced.shape[-1])
    nxt = torch.einsum("ij,jml->iml", state, reduced)
    return nxt.reshape(-1, nxt.shape[-1])


def chain_step_dense(state, core):
    if state is None:
        return core.reshape(-1, core.shape[-1])
    nxt = torch.einsum("ij,jkl->ikl", state, core)
    return nxt.reshape(-1, nxt.shape[-1])


class TensorTrainDRM(
    CansketchSparse,
    CansketchTT,
    CansketchCP,
    CansketchDense,
    CansketchTucker,
    CanSlice,
):
    """DRM whose μ-th sketching matrix is the prefix contraction of a fixed
    norm-preserving random TT (last core dropped).

    The cores are drawn on the host exactly as the JAX package draws them
    (bit-identical for equal seed and dtype) and then moved to ``device``.
    Given ``cores``, the DRM lives on their device.
    """

    cores: List[torch.Tensor]

    def __init__(
        self,
        rank: Union[Tuple[int, ...], int],
        shape: Tuple[int, ...],
        transpose: bool,
        seed: Optional[int] = None,
        cores: Optional[List[torch.Tensor]] = None,
        device=None,
        **kwargs,
    ) -> None:
        if cores is not None:
            device = cores[0].device
        super().__init__(rank, shape, transpose, seed=seed, device=device,
                         **kwargs)
        if cores is not None:
            self.cores = list(cores)
        else:
            tt_shape = self.shape[::-1] if transpose else self.shape
            tt = TensorTrain.random(
                tt_shape,
                self.true_rank,
                self.seed,
                norm_goal="norm-preserve",
                dtype=self.dtype,
                device=self.device,
            )
            self.cores = tt.cores[:-1]

    def _slice(self, mat, mu: int):
        return mat[:, self.rank_min[mu]: self.rank_max[mu]]

    @handle_transpose
    def sketch_sparse(self, tensor) -> List[torch.Tensor]:
        """Per-mode ``(rank[mu], nnz)`` rows of the DRM at the nonzeros'
        prefix indices, by the sparse chain."""
        out, state_t = [], None
        for mu, core in enumerate(self.cores):
            state_t = chain_step_sparse_t(state_t, core, tensor.indices[mu])
            out.append(state_t[self.rank_min[mu]: self.rank_max[mu], :])
        return out

    @handle_transpose
    def sketch_cp(self, tensor) -> List[torch.Tensor]:
        out, state = [], None
        for mu, core in enumerate(self.cores):
            state = chain_step_cp(state, core, tensor.cores[mu])
            out.append(self._slice(state, mu))
        return out

    @handle_transpose
    def sketch_tucker(self, tensor) -> List[torch.Tensor]:
        out, state = [], None
        for mu, core in enumerate(self.cores):
            state = chain_step_tucker(state, core, tensor.factors[mu])
            out.append(self._slice(state, mu))
        return out

    @handle_transpose
    def sketch_tt(self, tensor) -> List[torch.Tensor]:
        out, state = [], None
        for mu, core in enumerate(self.cores):
            state = chain_step_tt(state, core, tensor.cores[mu])
            out.append(self._slice(state, mu))
        return out

    @handle_transpose
    def sketch_dense(self, tensor) -> List[torch.Tensor]:
        """Per-mode DRM matrices ``(rank, n_1⋯n_{μ+1})``.

        For the transposed (right) DRM the chain runs over the reversed
        tensor, so its natural row enumeration is reversed-mode-major; it is
        re-enumerated to pair index-for-index with the *original* tensor's
        C-order suffix flattening, as in the JAX package.  This path
        materializes O(N·r) matrices and suits small tensors only; large
        dense tensors go through ``kernels.dense_engine``.
        """
        out, state = [], None
        for mu, core in enumerate(self.cores):
            state = chain_step_dense(state, core)
            mat = self._slice(state, mu)  # (ñ_0⋯ñ_mu, r)
            if self.transpose:
                dims = tuple(tensor.shape[: mu + 1])
                mat = mat.reshape(dims + (-1,))
                mat = mat.permute(tuple(range(mu, -1, -1)) + (mu + 1,))
                mat = mat.reshape(-1, mat.shape[-1])
            out.append(mat.T)
        return out
