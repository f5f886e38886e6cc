"""Format × DRM dispatch and the general sketching engine.

Counterpart of ``tt_sketch_tpu/engine/dispatch.py``.  ``general_sketch`` is
the one engine behind all three methods:

- ``streaming``: the left/right contractions of every μ are independent and
  the result is a linear function of the tensor.  A sparse tensor with a
  float32/bfloat16 pair of hash-family DRMs (``SparseGaussianDRM``,
  ``SparseSignDRM``) runs entirely through the fused sparse kernels
  (``sparse_streaming_sketch_fused``).
- ``orthogonal`` / ``hmt``: the left sketch at step μ is the contraction of
  the *already orthogonalized* Ψ cores with the tensor, so the μ-loop is a
  sequential chain (``_OrthogChain``), advanced with the same step
  functions as the TT-DRM.  On sparse input the chain step is the
  ``chain_step_t`` kernel and Ψ takes the half-fused and grouped kernels.

A ``TensorSum`` is sketched summand by summand (linearity): each summand
takes its own format's functions with the DRMs passed through, so a sparse
shard with plans takes the fused kernels, and the sequential chain keeps
one child chain per summand.
"""
from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional

import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.drm.tensor_train_drm import (
    chain_step_cp,
    chain_step_dense,
    chain_step_sparse_t,
    chain_step_tt,
    chain_step_tucker,
)
from tt_sketch_torch.engine.sketch_container import SketchContainer
from tt_sketch_torch.formats import (
    CPTensor,
    DenseTensor,
    SparseTensor,
    TensorSum,
    TensorTrain,
    TuckerTensor,
)
from tt_sketch_torch.kernels import sketch_kernels as K
from tt_sketch_torch.utils import right_mul_pinv


class SketchMethod(enum.Enum):
    streaming = "streaming"
    orthogonal = "orthogonal"
    hmt = "hmt"


DRM_SKETCH_METHOD_DISPATCH = {
    SparseTensor: "sketch_sparse",
    TensorTrain: "sketch_tt",
    DenseTensor: "sketch_dense",
    CPTensor: "sketch_cp",
    TuckerTensor: "sketch_tucker",
}

OMEGA_METHODS: Dict[type, Callable] = {
    SparseTensor: K.sketch_omega_sparse,
    TensorTrain: K.sketch_omega_tt,
    DenseTensor: K.sketch_omega_dense,
    CPTensor: K.sketch_omega_cp,
    TuckerTensor: K.sketch_omega_tucker,
}

PSI_METHODS: Dict[type, Callable] = {
    SparseTensor: K.sketch_psi_sparse,
    TensorTrain: K.sketch_psi_tt,
    DenseTensor: K.sketch_psi_dense,
    CPTensor: K.sketch_psi_cp,
    TuckerTensor: K.sketch_psi_tucker,
}


# -- TensorSum: distribute over summands (linearity) -------------------------

class _PerSummandView:
    """Lazy per-μ view over per-summand contraction lists: element ``i`` is
    ``per_summand[i][mu]``, read on first access, so a sparse summand whose
    Ψ/Ω take the fused kernels never generates its DRM rows (the lists may
    be ``LazyModeList``s)."""

    def __init__(self, per_summand, mu: int) -> None:
        self._ps = per_summand
        self._mu = mu

    def __len__(self) -> int:
        return len(self._ps)

    def __getitem__(self, i: int):
        return self._ps[i][self._mu]

    def __iter__(self):
        return (self[i] for i in range(len(self._ps)))


def _side(arr, i: int, summand):
    """Element ``i`` of a per-summand side: a thunk for a sparse summand
    (its Ψ/Ω functions may never read the rows), the array for any
    other."""
    if arr is None:
        return None
    if isinstance(summand, SparseTensor):
        return lambda: arr[i]
    return arr[i]


def sketch_omega_sum(left_arr, right_arr, *, tensor, **kwargs):
    omega = 0.0
    for i, summand in enumerate(tensor.tensors):
        omega = omega + OMEGA_METHODS[type(summand)](
            _side(left_arr, i, summand), _side(right_arr, i, summand),
            tensor=summand, **kwargs
        )
    return omega


def sketch_psi_sum(left_arr, right_arr, *, tensor, **kwargs):
    psi = 0.0
    for i, summand in enumerate(tensor.tensors):
        psi = psi + PSI_METHODS[type(summand)](
            _side(left_arr, i, summand), _side(right_arr, i, summand),
            tensor=summand, **kwargs
        )
    return psi


OMEGA_METHODS[TensorSum] = sketch_omega_sum
PSI_METHODS[TensorSum] = sketch_psi_sum


def _sum_sketch(tensor: TensorSum, drm) -> List[_PerSummandView]:
    """Per-μ lazy views of the per-summand contraction lists."""
    per_summand = [
        get_sketch_method(summand, drm)(summand) for summand in tensor.tensors
    ]
    return [_PerSummandView(per_summand, mu)
            for mu in range(len(tensor.shape) - 1)]


def get_sketch_method(tensor, drm) -> Callable:
    if type(tensor) in DRM_SKETCH_METHOD_DISPATCH:
        return getattr(drm, DRM_SKETCH_METHOD_DISPATCH[type(tensor)])
    if isinstance(tensor, TensorSum):
        return lambda t: _sum_sketch(t, drm)
    raise ValueError(f"DRM of type {type(drm)} can't sketch {type(tensor)}")


def _check_placement(tensor, drm) -> None:
    """DRM and tensor must share device and dtype: torch neither moves nor
    promotes silently across them, and the port does not either.  A DRM
    with cores is where its cores are; a hash DRM is where it generates.
    None (HMT has no left DRM) passes."""
    if drm is None:
        return
    cores = getattr(drm, "cores", None)
    device = cores[0].device if cores else drm.device
    dtype = cores[0].dtype if cores else drm.dtype
    if device != tensor.device:
        raise ValueError(
            f"{drm!r} lies on {device}, the tensor on {tensor.device}"
        )
    if dtype != tensor.dtype:
        raise ValueError(
            f"{drm!r} has dtype {dtype}, the tensor {tensor.dtype}; "
            f"pass dtype= to the sketch"
        )


# -- orthogonalization step and incremental left chain -----------------------

def orth_step(Psi: torch.Tensor, Omega: Optional[torch.Tensor]) -> torch.Tensor:
    """QR-orthogonalize a Ψ core (after an optional ``Ψ Ω⁺`` solve, which
    changes the trailing rank to ``Omega.shape[0]``)."""
    r1, n, r2 = Psi.shape
    final_r2 = r2 if Omega is None else Omega.shape[0]
    mat = Psi.reshape(r1 * n, r2)
    if Omega is not None:
        mat = right_mul_pinv(mat, Omega)
    Q, _ = torch.linalg.qr(mat)
    return Q.reshape(r1, n, final_r2)


class _OrthogChain:
    """Left-sketch chain built from orthogonalized Ψ cores.

    ``push(core)`` absorbs one (1 if first, else r×n×r) orthogonalized core
    and returns the left contraction to use for the next Ψ, in the layout
    the format's Ψ function expects from a left DRM.  A ``TensorSum``
    keeps one child chain per summand and returns their outputs as a
    tuple, which the sum's Ψ function hands out summand by summand.
    """

    def __init__(self, tensor) -> None:
        self.tensor = tensor
        self.mu = 0
        if isinstance(tensor, TensorSum):
            self.children = [_OrthogChain(t) for t in tensor.tensors]
        elif type(tensor) in DRM_SKETCH_METHOD_DISPATCH:
            self.children = None
            self.state = None
        else:
            raise ValueError(f"Cannot chain-sketch {type(tensor)}")

    def push(self, core: torch.Tensor):
        if self.children is not None:
            return tuple(child.push(core) for child in self.children)
        t, mu = self.tensor, self.mu
        if isinstance(t, SparseTensor):
            # state kept transposed (r, nnz): what the chain kernel writes
            # and the Ψ kernels read
            self.state = chain_step_sparse_t(self.state, core, t.indices[mu])
            out = self.state
        elif isinstance(t, TensorTrain):
            self.state = chain_step_tt(self.state, core, t.cores[mu])
            out = self.state
        elif isinstance(t, CPTensor):
            self.state = chain_step_cp(self.state, core, t.cores[mu])
            out = self.state
        elif isinstance(t, TuckerTensor):
            self.state = chain_step_tucker(self.state, core, t.factors[mu])
            out = self.state
        else:
            self.state = chain_step_dense(self.state, core)
            out = self.state.T
        self.mu += 1
        return out


# -- the engine --------------------------------------------------------------

def general_sketch(
    tensor,
    left_drm,
    right_drm,
    method: SketchMethod,
) -> SketchContainer:
    """Compute the (Ψ, Ω) sketch of ``tensor`` with the given DRM pair
    (``left_drm`` is None for HMT)."""
    if method != SketchMethod.hmt and left_drm is None:
        raise ValueError(f"left_drm must be provided for method '{method}'")
    for drm in (left_drm, right_drm):
        _check_placement(tensor, drm)
    sparse = isinstance(tensor, SparseTensor)
    if (method == SketchMethod.streaming and sparse
            and K.sparse_fused_applies(tensor, left_drm, right_drm)):
        Psi_cores, Omega_mats = K.sparse_streaming_sketch_fused(
            tensor, left_drm, right_drm
        )
        return SketchContainer(Psi_cores, Omega_mats)

    n_dims = len(tensor.shape)
    if method != SketchMethod.hmt:
        left_contractions = get_sketch_method(tensor, left_drm)(tensor)
    right_contractions = get_sketch_method(tensor, right_drm)(tensor)

    # The Ψ/Ω functions see the DRM objects so that hash-family DRMs take
    # the kernels that hash their rows themselves.  For the sequential
    # methods the left side of Ψ is the orthogonalized-core chain, an array
    # and not a DRM, so Ψ sees the right DRM only (the half-fused kernel
    # then hashes the right rows and reads the chain rows); Ω (orthogonal
    # only) sees both DRMs.
    if method == SketchMethod.streaming:
        psi_kwargs = {"left_drm": left_drm, "right_drm": right_drm}
    else:
        psi_kwargs = {"right_drm": right_drm}
    omega_kwargs = {"left_drm": left_drm, "right_drm": right_drm}

    def _lazy_side(contractions, k: int):
        # the sparse functions take thunks: a fused path never reads the
        # rows, so a LazyModeList element is not generated for it
        if sparse:
            return lambda: contractions[k]
        return contractions[k]

    Omega_mats: List[torch.Tensor] = []
    if method != SketchMethod.hmt:
        omega_method = OMEGA_METHODS[type(tensor)]
        for mu in range(n_dims - 1):
            with profiling.span(f"tt.mode.{mu}"):
                Omega_mats.append(
                    omega_method(
                        _lazy_side(left_contractions, mu),
                        _lazy_side(right_contractions, mu),
                        tensor=tensor,
                        mu=mu,
                        **omega_kwargs,
                    )
                )

    sequential = method in (SketchMethod.hmt, SketchMethod.orthogonal)
    if sequential:
        chain = _OrthogChain(tensor)

    Psi_cores: List[torch.Tensor] = []
    psi_method = PSI_METHODS[type(tensor)]
    for mu in range(n_dims):
        with profiling.span(f"tt.mode.{mu}"):
            if mu == 0:
                left_sketch = None
            elif sequential:
                left_sketch = chain.push(Psi_cores[-1])
            else:
                left_sketch = _lazy_side(left_contractions, mu - 1)
            right_sketch = (_lazy_side(right_contractions, mu)
                            if mu < n_dims - 1 else None)
            Psi = psi_method(
                left_sketch, right_sketch, tensor=tensor, mu=mu, **psi_kwargs
            )
            if mu < n_dims - 1:
                if method == SketchMethod.orthogonal:
                    Psi = orth_step(Psi, Omega_mats[mu])
                elif method == SketchMethod.hmt:
                    Psi = orth_step(Psi, None)
            Psi_cores.append(Psi)

    return SketchContainer(Psi_cores, Omega_mats)
