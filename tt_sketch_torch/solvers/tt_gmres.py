"""TT-GMRES with sketched rounding (counterpart of
``tt_sketch_tpu/solvers/tt_gmres.py``).

GMRES in the TT format per Dolgov arXiv:1206.5512, where the rank growth of
``A @ x`` is tamed by rounding each Arnoldi vector: classically (TT-SVD on
the accumulated sum) or with the streaming sketch ("sketch" mode), which
rounds a sum of k TTs in one linear pass instead of k pairwise SVD rounds.

The port keeps the JAX package's two routes.  The eager route reads each
rounding's singular values on the host; the device-resident route rounds
with static ranks and masks (``tt_ops.tt_round_masked``).  Both bundle an
iteration's Gram–Schmidt dots, the new norm and the effective ranks into
one device→host copy.  ``device_resident="auto"`` means "the right-hand
side's cores lie on a CUDA device" (the JAX package: "on a TPU").
"""
from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from collections import defaultdict
from math import ceil
from time import perf_counter
from typing import Any, Dict, List, Literal, Optional, Tuple, Union

import numpy as np
import torch

from tt_sketch_torch.config import DEFAULT_DTYPE, resolve_device
from tt_sketch_torch.engine.sketch import orthogonal_sketch, stream_sketch
from tt_sketch_torch.formats.base import Tensor
from tt_sketch_torch.formats.tensor_sum import TensorSum
from tt_sketch_torch.formats.tensor_train import TensorTrain
from tt_sketch_torch.utils import (
    TTRank,
    dematricize,
    matricize,
    process_tt_rank,
    random_normal,
)


def _on_device(x, device) -> torch.Tensor:
    """A numpy array (copied: it may be read-only) or torch tensor on
    ``device`` (``None``: the package default)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(resolve_device(device))


class TTLinearMap(ABC):
    """Abstract linear map acting on tensor trains."""

    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]

    @abstractmethod
    def __call__(self, other: TensorTrain) -> TensorTrain:
        ...


class MPO(Tensor, TTLinearMap):
    """Matrix-product operator: order-4 cores
    ``(rank[mu-1], in_shape[mu], out_shape[mu], rank[mu])`` used as a TT
    linear map (application multiplies TT ranks;
    ``tt_sketch_tpu/solvers/tt_gmres.py:45-130``)."""

    def __init__(self, cores: List[torch.Tensor]) -> None:
        self.cores = list(cores)
        self.in_shape = tuple(int(C.shape[1]) for C in self.cores)
        self.out_shape = tuple(int(C.shape[2]) for C in self.cores)
        self.rank = tuple(int(C.shape[0]) for C in self.cores[1:])
        self.shape = tuple(
            s1 * s2 for s1, s2 in zip(self.in_shape, self.out_shape)
        )

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.cores[0].dtype

    @property
    def size(self) -> int:
        return sum(int(np.prod(C.shape)) for C in self.cores)

    @property
    def T(self) -> MPO:
        """Transpose as a linear map (swap in/out physical legs)."""
        return MPO([C.permute(0, 2, 1, 3) for C in self.cores])

    def to_tt(self) -> TensorTrain:
        return TensorTrain([
            C.reshape(C.shape[0], C.shape[1] * C.shape[2], C.shape[3])
            for C in self.cores
        ])

    def to_dense(self) -> torch.Tensor:
        """Dense tensor of shape (in₀, out₀, ..., in_{d-1}, out_{d-1})."""
        res = self.cores[0]
        res = res.reshape(res.shape[1:])
        for C in self.cores[1:]:
            res = torch.einsum("...i,ijkl->...jkl", res, C)
        return res.reshape(res.shape[:-1])

    def __call__(self, other: TensorTrain) -> TensorTrain:
        new_cores = []
        for M, C in zip(self.cores, other.cores):
            MC = torch.einsum("ijkl,ajb->iaklb", M, C)
            new_cores.append(MC.reshape(
                MC.shape[0] * MC.shape[1], MC.shape[2],
                MC.shape[3] * MC.shape[4],
            ))
        return TensorTrain(new_cores)

    def __mul__(self, other: float) -> MPO:
        new_cores = list(self.cores)
        new_cores[0] = new_cores[0] * other
        return MPO(new_cores)

    @classmethod
    def random(
        cls,
        rank: TTRank,
        in_shape: Tuple[int, ...],
        out_shape: Tuple[int, ...],
        seed: Optional[int] = None,
        dtype=None,
        device=None,
    ) -> MPO:
        """Random symmetric-ish MPO, core norms ~ sqrt(s1*s2); the draws
        are the JAX package's (``random_normal`` per spawned core seed)."""
        prod_shape = tuple(s1 * s2 for s1, s2 in zip(in_shape, out_shape))
        rank = process_tt_rank(rank, prod_shape, trim=True)
        seeds = np.random.SeedSequence(seed).generate_state(len(in_shape))
        cores = []
        for r1, s1, s2, r2, s in zip(
            (1,) + rank, in_shape, out_shape, rank + (1,), seeds
        ):
            C = random_normal((r1, s1, s2, r2), seed=int(s), dtype=dtype,
                              device=device)
            C = C + C.permute(0, 2, 1, 3).reshape(C.shape)
            C = C * (float(np.sqrt(s1 * s2)) / torch.linalg.norm(C))
            cores.append(C)
        return cls(cores)

    @classmethod
    def eye(cls, shape: Tuple[int, ...], dtype=None, device=None) -> MPO:
        dtype = dtype or DEFAULT_DTYPE
        device = resolve_device(device)
        return cls([torch.eye(s, dtype=dtype, device=device)[None, :, :, None]
                    for s in shape])


class TTPrecond(TTLinearMap):
    """Mode-wise preconditioner: multiply one mode by ``A⁻¹`` through a QR
    of ``A`` made once, then a triangular solve per call
    (``tt_sketch_tpu/solvers/tt_gmres.py:133-161``).  ``A`` (numpy or
    torch) moves to ``device``."""

    def __init__(self, A, shape: Tuple[int, ...], mode: int = 0,
                 device=None) -> None:
        self.A = _on_device(A, device)
        self.Q, self.R = torch.linalg.qr(self.A)
        self.mode = mode
        self.in_shape = tuple(shape)
        self.out_shape = tuple(shape)

    def backward_call(self, other: TensorTrain) -> TensorTrain:
        new_cores = list(other.cores)
        C = new_cores[self.mode]
        C_mat = matricize(C, mode=1, mat_shape=True)
        sol = torch.linalg.solve_triangular(self.R, self.Q.mT @ C_mat,
                                            upper=True)
        new_cores[self.mode] = dematricize(sol, mode=1, shape=C.shape)
        return TensorTrain(new_cores)

    def forward_call(self, other: TensorTrain) -> TensorTrain:
        new_cores = list(other.cores)
        C = new_cores[self.mode]
        C_mat = matricize(C, mode=1, mat_shape=True)
        new_cores[self.mode] = dematricize(self.A @ C_mat, mode=1,
                                           shape=C.shape)
        return TensorTrain(new_cores)

    __call__ = backward_call


class TTLinearMapSum:
    """A sum of TT linear maps: eats a TT (or sum of TTs), returns the
    TensorSum of every map applied to every summand
    (``tt_sketch_tpu/solvers/tt_gmres.py:164-189``)."""

    def __init__(self, linear_maps: List[TTLinearMap]) -> None:
        if len(linear_maps) == 0:
            raise ValueError("linear_maps cannot be empty")
        self.linear_maps = list(linear_maps)
        self.in_shape = linear_maps[0].in_shape
        self.out_shape = linear_maps[0].out_shape
        for lm in linear_maps[1:]:
            if lm.in_shape != self.in_shape:
                raise ValueError("in_shape mismatch")
            if lm.out_shape != self.out_shape:
                raise ValueError("out_shape mismatch")

    def __call__(
        self, input_tensor: Union[TensorTrain, TensorSum]
    ) -> TensorSum:
        tensor_list = (
            [input_tensor]
            if isinstance(input_tensor, TensorTrain)
            else input_tensor.tensors
        )
        return TensorSum(
            [lm(t) for lm in self.linear_maps for t in tensor_list]
        )


ROUNDING_MODE = Literal["exact", "pairwise", "sketch", "orth_sketch", None]

#: Arnoldi (happy) breakdown threshold: ``H[j+1,j] <= _BREAKDOWN_TOL·β``
#: means the new Krylov direction is numerically zero — the solution lies in
#: the current subspace.
_BREAKDOWN_TOL = 1e-13


def round_tt_sum(
    tt_sum: TensorSum,
    max_rank: TTRank,
    eps: Optional[float] = None,
    method: ROUNDING_MODE = "sketch",
    oversample_factor: float = 2,
    seed: Optional[int] = None,
) -> TensorTrain:
    """Round a sum of TTs to ``max_rank``
    (``tt_sketch_tpu/solvers/tt_gmres.py:201-253``).

    - ``exact``: direct-sum everything then one TT-SVD round.
    - ``pairwise``: fold in each summand with a round after each add.
    - ``sketch``: one streaming sketch of the whole sum (the fast path).
    - ``orth_sketch``: orthogonal sketch of the sum.
    - ``None``: no rounding.

    The sketch modes draw their DRMs with the summands' dtype and on their
    device.
    """
    if isinstance(tt_sum, TensorTrain):
        tt_sum = TensorSum([tt_sum])
    first = tt_sum.tensors[0].cores[0]
    placement = dict(dtype=first.dtype, device=first.device)
    if method == "exact":
        tt = tt_sum.tensors[0]
        for t in tt_sum.tensors[1:]:
            tt = tt.add(t)
        return tt.round(eps, max_rank)
    if method == "pairwise":
        tt = tt_sum.tensors[0]
        for t in tt_sum.tensors[1:]:
            tt = tt.add(t).round(eps=eps, max_rank=max_rank)
        return tt
    if method in ("sketch", "orth_sketch"):
        left_rank = process_tt_rank(max_rank, tt_sum.shape, trim=True)
        right_rank = tuple(ceil(r * oversample_factor) for r in left_rank)
        if method == "sketch":
            return stream_sketch(
                tt_sum, left_rank=left_rank, right_rank=right_rank,
                seed=seed, compile=True, **placement,
            ).to_tt()
        return orthogonal_sketch(
            tt_sum, left_rank=left_rank, right_rank=right_rank, seed=seed,
            **placement,
        )
    if method is None:
        return tt_sum  # type: ignore[return-value]
    raise ValueError(f"Unknown rounding method: {method}")


def _round_tt_sum_static(
    tt_sum: TensorSum,
    max_rank: TTRank,
    eps=None,
    method: ROUNDING_MODE = "sketch",
    oversample_factor: float = 2,
    seed: Optional[int] = None,
) -> Tuple[TensorTrain, Optional[torch.Tensor]]:
    """``round_tt_sum`` with static output ranks and no host read
    (``tt_sketch_tpu/solvers/tt_gmres.py:256-300``).

    The SVD-based modes go through ``round_masked``: the TT has static
    ranks capped at ``max_rank``, entries past the eps rank exact zeros,
    and the effective ranks come back as a device tensor (``None`` for the
    sketch modes, whose ranks are static anyway).  ``eps`` may be a 0-d
    tensor.
    """
    if isinstance(tt_sum, TensorTrain):
        tt_sum = TensorSum([tt_sum])
    if method == "exact":
        tt = tt_sum.tensors[0]
        for t in tt_sum.tensors[1:]:
            tt = tt.add(t)
        return tt.round_masked(eps, max_rank)
    if method == "pairwise":
        tt = tt_sum.tensors[0]
        eff = None
        for t in tt_sum.tensors[1:]:
            tt, eff = tt.add(t).round_masked(eps, max_rank)
        if eff is None:  # single summand: still round
            tt, eff = tt.round_masked(eps, max_rank)
        return tt, eff
    return (
        round_tt_sum(tt_sum, max_rank, eps=None, method=method,
                     oversample_factor=oversample_factor, seed=seed),
        None,
    )


def _stacked_tt_dots(w: TensorTrain, nus: List[TensorTrain]) -> torch.Tensor:
    """All inner products ``⟨w, ν_i⟩`` as one device tensor (no host sync).

    When the ν share core shapes (always so under static-rank rounding)
    their cores are stacked on a leading batch axis and the dots run as one
    sweep of batched ``einsum``s (the JAX package's ``jax.vmap`` of
    ``tt_dot``, ``tt_sketch_tpu/solvers/tt_gmres.py:303-324``); otherwise
    one dot per ν."""
    shapes = {tuple(C.shape for C in nu.cores) for nu in nus}
    if len(shapes) == 1 and len(nus) > 1:
        stacked = [torch.stack([nu.cores[mu] for nu in nus])
                   for mu in range(len(nus[0].cores))]
        res = torch.einsum("ijk,bljm->bkm", w.cores[0], stacked[0])
        for C1, C2 in zip(w.cores[1:], stacked[1:]):
            res = torch.einsum("bij,ika->bjka", res, C1)
            res = torch.einsum("bjka,bjkc->bac", res, C2)
        return res.sum(dim=(1, 2))
    return torch.stack([w.dot_device(nu) for nu in nus])


def tt_sum_gmres(
    A: TTLinearMapSum,
    b: TensorTrain,
    max_rank: TTRank,
    precond: Optional[TTPrecond] = None,
    final_round_rank: Optional[TTRank] = None,
    x0: Optional[TensorTrain] = None,
    tolerance: float = 1e-6,
    maxiter: int = 100,
    symmetric: bool = False,
    rounding_method: ROUNDING_MODE = "pairwise",
    rounding_method_final: Optional[ROUNDING_MODE] = None,
    save_basis: bool = False,
    verbose: bool = False,
    seed: Optional[int] = None,
    device_resident: Union[bool, str] = "auto",
) -> Tuple[TensorTrain, Dict[str, Any]]:
    """GMRES for a ``TTLinearMapSum`` with per-iteration rounding
    (``tt_sketch_tpu/solvers/tt_gmres.py:327-532``), on the device ``b``
    lies on.

    Returns ``(solution, history)``: residual norms, ranks, per-step wall
    times, rounding tolerances, ``breakdown`` and ``converged``, and with
    ``save_basis`` the Hessenberg matrix, the basis, ``y`` and the
    unrounded solution sum.  ``seed`` makes the sketched rounding
    deterministic (one derived seed per rounding call).

    ``device_resident`` ("auto": ``b``'s cores lie on CUDA): route the
    SVD-based rounding modes through the masked static-rank sweep.  Both
    routes read one bundle a Gram–Schmidt step (dots, norm, effective
    ranks).  Arnoldi breakdown (``H[j+1,j] ≈ 0``) is detected explicitly,
    and the reported residual is the explicit ``‖H_red·y − β·e₁‖``.
    The default ``x0`` is a rank-1 zero TT with ``b``'s dtype and device.
    """
    if final_round_rank is None:
        final_round_rank = max_rank
    if rounding_method_final is None:
        rounding_method_final = rounding_method
    if A.out_shape != tuple(b.shape):
        raise ValueError("Output shape of linear map doesn't match RHS")
    if x0 is not None and tuple(x0.shape) != A.in_shape:
        raise ValueError("Input shape of linear map doesn't match x0")
    if A.out_shape != A.in_shape:
        raise ValueError("TT-GMRES only works for automorphisms")

    max_rank = process_tt_rank(max_rank, A.in_shape, trim=True)
    if x0 is None:
        x0 = TensorTrain.zero(shape=A.in_shape, rank=1, dtype=b.dtype,
                              device=b.device)
    if device_resident == "auto":
        device_resident = b.device.type == "cuda"

    _round_counter = [0]

    def _round(tt_sum, **kw):
        """Round; returns ``(tt, eff_ranks_or_None)``."""
        _round_counter[0] += 1
        kw_seed = None if seed is None else seed + _round_counter[0]
        if device_resident:
            return _round_tt_sum_static(tt_sum, seed=kw_seed, **kw)
        return round_tt_sum(tt_sum, seed=kw_seed, **kw), None

    def apply_A_pr(x: TensorTrain) -> TensorSum:
        res = A(x)
        if precond is not None:
            res = TensorSum([precond(r) for r in res.tensors])
        return res

    b_pr = precond(b) if precond is not None else b

    b_norm = b.norm()
    initial_time = perf_counter()
    residual = b_pr - apply_A_pr(x0)
    residual_rounded, eff0 = _round(
        residual, max_rank=max_rank, method=rounding_method
    )
    residual_norm = residual_rounded.norm()
    beta = residual_norm
    if beta == 0.0:
        history0: Dict[str, Any] = defaultdict(list)
        history0["residual_norm"].append(0.0)
        history0["converged"] = True
        history0["total_time"] = perf_counter() - initial_time
        return x0, history0
    nu_list: List[TensorTrain] = [residual_rounded / beta]
    H_matrix = np.zeros((maxiter + 1, maxiter))

    history: Dict[str, Any] = defaultdict(list)
    history["w_norm"].append(beta)
    history["rank"].append(
        tuple(int(r) for r in eff0.tolist())
        if eff0 is not None
        else residual_rounded.rank
    )
    history["residual_norm"].append(residual_norm / b_norm)
    history["step_time"].append(perf_counter() - initial_time)
    history["breakdown"] = False
    history["converged"] = False

    y = np.zeros(0)
    n_nu = 1  # usable basis vectors (excludes a post-breakdown direction)
    for j in range(maxiter):
        current_time = perf_counter()
        delta = tolerance / (residual_norm / beta)
        if verbose:
            logging.info(
                "Iteration %d/%d, residual norm: %.4e",
                j + 1,
                maxiter,
                residual_norm / b_norm,
            )
        w_sum = apply_A_pr(nu_list[-1])
        w_rounded, _ = _round(
            w_sum, eps=delta, max_rank=max_rank, method=rounding_method
        )

        min_j = max(0, j - 2) if symmetric else 0
        # Gram–Schmidt: all dots in one batch, the subtraction with device
        # scalar coefficients, the norm on the device, then one bundled
        # device→host copy per iteration (dots, norm, effective ranks).
        h_col = _stacked_tt_dots(w_rounded, nu_list[min_j: j + 1])
        w_sum = w_rounded - TensorSum(nu_list[min_j: j + 1]) * h_col
        w_rounded, eff = _round(
            w_sum, eps=delta, max_rank=max_rank, method=rounding_method
        )
        h_next = w_rounded.norm_device()
        bundle = [h_col.reshape(-1), h_next.reshape(-1)]
        if eff is not None:
            bundle.append(eff.reshape(-1).to(h_col.dtype))
        vals = torch.cat(bundle).cpu().numpy()
        n_dots = j + 1 - min_j
        H_matrix[min_j: j + 1, j] = vals[:n_dots]
        H_matrix[j + 1, j] = vals[n_dots]
        if eff is not None:
            eff_ranks = tuple(int(r) for r in vals[n_dots + 1:])
        else:
            eff_ranks = w_rounded.rank
        history["step_time"].append(perf_counter() - current_time)

        breakdown = not (H_matrix[j + 1, j] > _BREAKDOWN_TOL * beta)
        if not breakdown:
            # float(): a np.float64 coefficient would promote f32 TTs
            nu_list.append(w_rounded / float(H_matrix[j + 1, j]))
            n_nu = j + 2

        H_red = H_matrix[: j + 2, : j + 1]
        e1 = np.zeros(j + 2)
        e1[0] = beta
        y = np.linalg.lstsq(H_red, e1, rcond=None)[0]
        # Explicit residual: honest under a rank-deficient Hessenberg
        # (lstsq's residual array is empty there).
        residual_norm = float(np.linalg.norm(H_red @ y - e1))
        history["step_time_with_res_norm"].append(
            perf_counter() - current_time
        )
        history["residual_norm"].append(residual_norm / b_norm)
        history["rank"].append(eff_ranks)
        history["w_norm"].append(H_matrix[j + 1, j])
        history["delta"].append(delta)

        if residual_norm / b_norm < tolerance:
            history["converged"] = True
            break
        if breakdown:
            # Happy breakdown: the Krylov space is exhausted; the lstsq
            # solution above is the best in the current subspace.
            history["breakdown"] = True
            if verbose:
                logging.info(
                    "Arnoldi breakdown at iteration %d "
                    "(H[j+1,j]=%.3e, beta=%.3e)",
                    j + 1,
                    H_matrix[j + 1, j],
                    beta,
                )
            break

    n_y = min(len(y), n_nu)
    y = y[:n_y]
    nu_list = nu_list[:n_y]
    current_time = perf_counter()
    result = x0 + TensorSum(nu_list) * [float(v) for v in y]
    result_rounded, eff_final = _round(
        result,
        eps=None,
        max_rank=final_round_rank,
        method=rounding_method_final,
    )
    if eff_final is not None:
        result_rounded = result_rounded.trim_to_ranks(eff_final)
    history["final_round_time"] = perf_counter() - current_time
    history["total_time"] = perf_counter() - initial_time
    if save_basis:
        history["H_matrix"] = H_matrix
        history["nu_list"] = nu_list
        history["y"] = y
        # the unrounded solution sum, to re-round at other target ranks
        history["solution_sum"] = result
    return result_rounded, history
