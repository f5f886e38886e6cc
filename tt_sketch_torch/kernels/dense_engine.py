"""Streaming sketch engine for dense tensors against TT-DRMs.

Counterpart of ``tt_sketch_tpu/kernels/dense_engine.py``.  All Ψ/Ω of a
dense tensor follow from chain contractions with O(N) peak memory instead of
the O(N·r) DRM matrices of ``TensorTrainDRM.sketch_dense``:

- ``dense_stream_sketch_fused``: backward/forward sweeps over X.
- ``dense_stream_sketch_bisect``: exactly two projections over one 2-D view
  of X, ``T = X2d @ R`` and ``U = Lᵀ @ X2d``, computed in one pass by the
  ``dual_project`` kernel; everything else is small core contractions.
- ``slab_stream_sketch``: mode-0 slabs summed by linearity, so tensors far
  larger than device memory stream through.

The core contractions around the projections stay ``torch.matmul`` /
``einsum``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.engine.sketch_container import SketchContainer
from tt_sketch_torch.kernels.dual_project import dual_project

PROJECTORS = ("auto", "kernel", "kernel_bf16", "matmul")


def _apply_core_left(state: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """Contract leading (rank, mode) axes of ``state`` with one left core.

    state: (r1, n, rest...); core: (r1, n, r2) -> (r2, rest...)
    """
    rest = state.shape[2:]
    mat = state.reshape(state.shape[0] * state.shape[1], -1)
    cmat = core.reshape(core.shape[0] * core.shape[1], core.shape[2])
    out = cmat.T @ mat
    return out.reshape((core.shape[2],) + tuple(rest))


def _apply_core_right(state: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """Contract trailing (mode, rank) axes of ``state`` with one reversed-DRM
    core.

    state: (..., n, r1); core: (r1, n, r2)  ->  (..., r2)
    """
    lead = state.shape[:-2]
    mat = state.reshape(-1, state.shape[-2] * state.shape[-1])
    cmat = core.permute(1, 0, 2).reshape(
        core.shape[1] * core.shape[0], core.shape[2]
    )
    out = mat @ cmat
    return out.reshape(tuple(lead) + (core.shape[2],))


def dense_stream_sketch_fused(
    X: torch.Tensor,
    left_cores: Sequence[torch.Tensor],
    right_cores: Sequence[torch.Tensor],
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """All Ψ/Ω of dense ``X`` against TT-DRM core chains.

    ``left_cores``: d-1 cores over ``shape`` (last core dropped), core μ of
    shape ``(r_μ, n_μ, r_{μ+1})`` with r_0 = 1.
    ``right_cores``: d-1 cores over ``shape[::-1]`` (the transposed DRM).

    Returns ``(Psi_cores, Omega_mats)`` equal (up to float order) to the
    generic engine with ``TensorTrainDRM`` on both sides.
    """
    d = X.ndim

    # Backward sweep: right_state[mu] = X contracted over modes mu+1..d-1
    # with the right chain; shape (n_0, ..., n_mu, r'_mu).
    right_states: List[Optional[torch.Tensor]] = [None] * (d - 1)
    state = X[..., None]  # (..., n_{d-1}, 1) — unit rank to start the chain
    for k in range(d - 1):
        # reversed-DRM core k covers original mode d-1-k
        state = _apply_core_right(state, right_cores[k])
        right_states[d - 2 - k] = state

    Psi_cores: List[torch.Tensor] = []
    Omega_mats: List[torch.Tensor] = []
    for mu in range(d - 1):
        st = right_states[mu][None, ...]  # (1, n_0, ..., n_mu, r')
        for k in range(mu):
            st = _apply_core_left(st, left_cores[k])
        # st: (r_l(mu-1)|1, n_mu, r') == Psi_mu; one more core gives Omega_mu
        Psi_cores.append(st)
        Omega_mats.append(_apply_core_left(st, left_cores[mu]))

    # Psi_{d-1} needs the left chain applied to X itself (forward sweep)
    state = X[None, ...]
    for k in range(d - 1):
        state = _apply_core_left(state, left_cores[k])
    Psi_cores.append(state[..., None])  # (r_l(d-2), n_{d-1}, 1)

    return Psi_cores, Omega_mats


def prefix_chain_tensor(
    left_cores: Sequence[torch.Tensor], n_cores: int
) -> torch.Tensor:
    """Materialize the left-DRM chain over modes ``0..n_cores-1``.

    Returns ``L`` of shape ``(n_0, ..., n_{n_cores-1}, r_{n_cores})`` with
    ``L[i_0..i_k, r] = (core_0[i_0] core_1[i_1] ⋯ core_{k}[i_k])[0, r]``.
    """
    L = left_cores[0][0]  # (n_0, r_1); leading rank of core 0 is 1
    for k in range(1, n_cores):
        L = torch.einsum("...a,anb->...nb", L, left_cores[k])
    return L


def suffix_chain_tensor(
    right_cores: Sequence[torch.Tensor], n_cores: int
) -> torch.Tensor:
    """Materialize the right-DRM chain over the LAST ``n_cores`` modes.

    ``right_cores[k]`` covers original mode ``d-1-k``.  Returns ``R`` of
    shape ``(n_{d-n_cores}, ..., n_{d-1}, ρ_{n_cores})`` — row-major
    flattening matches ``X.reshape(-1, suffix_prod)`` columns.
    """
    R = right_cores[0][0]  # (n_{d-1}, ρ_1)
    for k in range(1, n_cores):
        R = torch.einsum("anb,...a->n...b", right_cores[k], R)
    return R


def _prod(dims) -> int:
    out = 1
    for n in dims:
        out *= int(n)
    return out


def dense_stream_sketch_bisect(
    X: torch.Tensor,
    left_cores: Sequence[torch.Tensor],
    right_cores: Sequence[torch.Tensor],
    pivot: Optional[int] = None,
    projector: str = "matmul",
    shape: Optional[Tuple[int, ...]] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """All Ψ/Ω of dense ``X`` from two projections over one 2-D view.

    A pivot mode ``p`` splits the chains: ``L = core_0⋯core_p`` (shape
    ``(n_0⋯n_p, r)``) and ``R`` (shape ``(n_{p+1}⋯n_{d-1}, ρ)``) come from the
    DRM cores alone, and X is touched only by

        T = X2d @ R      # (n_0..n_p, ρ)   — right sketch of the prefix
        U = Lᵀ @ X2d     # (r, n_{p+1}..n_{d-1}) — left sketch of the suffix

    over ``X2d = X.reshape(n_0⋯n_p, n_{p+1}⋯n_{d-1})``.  Every Ψ_μ/Ω_μ then
    follows by small core contractions on T (μ ≤ p) or U (μ > p).  The
    default pivot balances the sizes of T and U.

    ``projector`` computes T and U:

    - ``"kernel"``: ``dual_project`` — the CUDA kernel for CUDA tensors
      (float32; one pass over X), its plain version for CPU tensors;
    - ``"kernel_bf16"``: the same with operands rounded to bfloat16;
    - ``"auto"``: ``"kernel"`` (the kernel takes every shape);
    - ``"matmul"``: two ``torch.matmul`` calls (two passes over X).

    They correspond to the JAX package's ``"pallas"``, ``"pallas_bf16"``,
    ``"auto"`` and ``"xla"``.

    ``X`` may be passed pre-flattened as the 2-D view ``(n_0⋯n_p,
    n_{p+1}⋯n_{d-1})`` together with the logical ``shape`` and an explicit
    ``pivot``.
    """
    if projector not in PROJECTORS:
        raise ValueError(f"projector must be one of {PROJECTORS}, got {projector!r}")
    if shape is not None:
        shape = tuple(int(n) for n in shape)
        d = len(shape)
        if X.ndim == 2 and d != 2:
            if pivot is None:
                raise ValueError("2-D X requires an explicit pivot")
            pre, suf = _prod(shape[: pivot + 1]), _prod(shape[pivot + 1:])
            if tuple(X.shape) != (pre, suf):
                raise ValueError(
                    f"2-D X of shape {tuple(X.shape)} is not the pivot-"
                    f"{pivot} flattening ({pre}, {suf}) of logical shape "
                    f"{shape}"
                )
        elif tuple(X.shape) != shape:
            raise ValueError(
                f"X.shape {tuple(X.shape)} does not match shape= {shape}"
            )
    else:
        d = X.ndim
        shape = tuple(X.shape)
    if d == 1:
        raise ValueError("need at least 2 modes")

    if pivot is None:
        # balance the two projection output sizes: pick the pivot
        # minimizing the summed sizes of T, U and the chains L, R
        best, pivot = None, 0
        for p in range(d - 1):
            pre, suf = _prod(shape[: p + 1]), _prod(shape[p + 1:])
            r_l = left_cores[p].shape[2]
            r_r = right_cores[d - 2 - p].shape[2]
            cost = pre * r_r + suf * r_l + pre * r_l + suf * r_r
            if best is None or cost < best:
                best, pivot = cost, p
    p = pivot
    if not 0 <= p <= d - 2:
        raise ValueError(f"pivot must be in [0, {d-2}], got {p}")

    X2d = X.reshape(_prod(shape[: p + 1]), -1)

    R = suffix_chain_tensor(right_cores, d - 1 - p)  # (n_{p+1}..n_{d-1}, ρ)
    L = prefix_chain_tensor(left_cores, p + 1)  # (n_0..n_p, r_{p+1})
    rho = R.shape[-1]
    r_next = L.shape[-1]
    R2 = R.reshape(-1, rho)
    L2 = L.reshape(-1, r_next)
    if projector == "matmul":
        T2, U2 = X2d @ R2, L2.T @ X2d
    else:
        compute = "bf16" if projector == "kernel_bf16" else "f32"
        T2, U2 = dual_project(
            X2d.contiguous(), R2.contiguous(), L2.contiguous(), compute=compute
        )
    T = T2.reshape(shape[: p + 1] + (rho,))
    U = U2.reshape((r_next,) + shape[p + 1:])

    Psi_cores: List[Optional[torch.Tensor]] = [None] * d
    Omega_mats: List[Optional[torch.Tensor]] = [None] * (d - 1)

    # --- prefix branch: T == right_states[p] of the sweep engine ---
    right_states: List[Optional[torch.Tensor]] = [None] * (p + 1)
    right_states[p] = T
    state = T
    for k in range(d - 1 - p, d - 1):
        state = _apply_core_right(state, right_cores[k])
        right_states[d - 2 - k] = state
    for mu in range(p + 1):
        st = right_states[mu][None, ...]
        for k in range(mu):
            st = _apply_core_left(st, left_cores[k])
        Psi_cores[mu] = st
        Omega_mats[mu] = _apply_core_left(st, left_cores[mu])

    # --- suffix branch: U = L_pᵀ X, modes p+1..d-1 ---
    if p + 1 <= d - 2:
        u_states: List[Optional[torch.Tensor]] = [None] * (d - 1)
        state = U[..., None]
        for k in range(d - 2 - p):
            state = _apply_core_right(state, right_cores[k])
            u_states[d - 2 - k] = state
        for mu in range(p + 1, d - 1):
            st = u_states[mu]  # (r_{p+1}, n_{p+1}, ..., n_mu, ρ)
            for k in range(p + 1, mu):
                st = _apply_core_left(st, left_cores[k])
            Psi_cores[mu] = st
            Omega_mats[mu] = _apply_core_left(st, left_cores[mu])
    # Ψ_{d-1}: finish the left chain on U
    st = U
    for k in range(p + 1, d - 1):
        st = _apply_core_left(st, left_cores[k])
    Psi_cores[d - 1] = st[..., None]

    return Psi_cores, Omega_mats  # type: ignore[return-value]


def dense_stream_sketch_container(
    X: torch.Tensor,
    left_cores: Sequence[torch.Tensor],
    right_cores: Sequence[torch.Tensor],
) -> SketchContainer:
    Psi_cores, Omega_mats = dense_stream_sketch_fused(X, left_cores, right_cores)
    return SketchContainer(Psi_cores, Omega_mats)


@profiling.spanned("tt.slab_stream_sketch")
def slab_stream_sketch(
    slab_fn,
    n_slabs: int,
    shape: Tuple[int, ...],
    left_cores: Sequence[torch.Tensor],
    right_cores: Sequence[torch.Tensor],
    dtype=None,
    engine: str = "bisect",
    projector: str = "auto",
    pivot: Optional[int] = None,
) -> SketchContainer:
    """Stream a huge dense tensor through the sketch in mode-0 slabs.

    ``slab_fn(i)`` produces slab ``i``, of shape ``(n0/n_slabs, n_1, ...,
    n_{d-1})`` or, with the bisect engine and an explicit ``pivot``, its 2-D
    pivot view.  By linearity, sketching slab ``i`` against the DRM with
    mode-0 core rows ``[i·s, (i+1)·s)`` and summing containers equals
    sketching the full tensor; Ψ_0 rows are produced per slab and
    concatenated.

    The first six parameters are the JAX package's, in its order.
    ``dtype`` is accepted for its signature and is unused there and here:
    each slab is sketched in its own dtype.

    Unlike the JAX package, which leaves the bisect engine at its two-GEMM
    default here, ``projector`` is handed to the bisect engine and defaults
    to ``"auto"``, i.e. the one-pass kernel on CUDA.  On the TPU the 2-GEMM
    default avoided a 4-D→2-D relayout copy of every slab; a contiguous
    torch slab reshapes to its 2-D view without a copy, so that reason does
    not apply.
    """
    del dtype
    n0 = shape[0]
    slab_size = n0 // n_slabs
    if slab_size * n_slabs != n0:
        raise ValueError(f"{n_slabs} slabs do not divide mode 0 of size {n0}")
    if engine not in ("bisect", "fused"):
        raise ValueError(f"engine must be 'bisect' or 'fused', got {engine!r}")
    slab_shape = (slab_size,) + tuple(shape[1:])

    psi0_rows = []
    acc_psis = None
    acc_omegas = None
    for i in range(n_slabs):
        with profiling.span("tt.slab"):
            slab = slab_fn(i)
            cores = [left_cores[0][:, i * slab_size: (i + 1) * slab_size, :]]
            cores += list(left_cores[1:])
            if engine == "bisect":
                psis, omegas = dense_stream_sketch_bisect(
                    slab, cores, right_cores, pivot=pivot,
                    projector=projector, shape=slab_shape,
                )
            else:
                psis, omegas = dense_stream_sketch_fused(slab, cores,
                                                         right_cores)
            psi0_rows.append(psis[0])
            rest = psis[1:]
            if acc_psis is None:
                acc_psis, acc_omegas = list(rest), list(omegas)
            else:
                acc_psis = [a + b for a, b in zip(acc_psis, rest)]
                acc_omegas = [a + b for a, b in zip(acc_omegas, omegas)]

    Psi_cores = [torch.cat(psi0_rows, dim=1)] + acc_psis
    return SketchContainer(Psi_cores, acc_omegas)
