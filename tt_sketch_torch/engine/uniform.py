"""Engine for *uniform* tensor trains (equal mode size and rank).

Counterpart of ``tt_sketch_tpu/engine/uniform.py``.  The order-scaling
experiment runs to d = 8192 modes.  A uniform TT is stored as ``(first,
interior, last)`` with the interior cores stacked along a leading mode axis,
so that the work of every edge that does not depend on its neighbours is one
batched call:

- streaming sketch: two chain loops and two batched einsums (Ψ, Ω)
- core recovery: one batched least-squares solve over all edges
- orthogonalize / fixed-rank rounding: QR / SVD loops
- direct-sum add, dot, norm, relative error

Each ``lax.scan`` of the JAX package is a Python loop here that writes into
a preallocated stacked output; a ``reverse=True`` scan runs backwards.  The
recovery's least squares (``utils._lstsq``) factors on a card with the
batched Jacobi kernel where the matrices fit it (``kernels/jacobi_svd``:
every edge of a rank-30 TT in one launch), else with ``torch.linalg.svd``;
the rounding's SVDs are ``torch.linalg.svd(full_matrices=False)`` on every
device.

Random cores come from one of two streams: ``"hash"``, the counter-based
generator of the DRMs (``rng.hash_rng.inds_to_normal``) at the JAX
package's global row counters, or ``"torch"``, an explicit
``torch.Generator`` on the target device.  The JAX package's ``"jax"``
stream (its PRNG) cannot be reproduced and raises.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tt_sketch_torch.config import DEFAULT_DTYPE, resolve_device
from tt_sketch_torch.formats.tensor_train import TensorTrain
from tt_sketch_torch.rng.hash_rng import inds_to_normal
from tt_sketch_torch.utils import _lstsq, right_mul_pinv

#: hashed draws generated per call of ``inds_to_normal`` (its int64
#: temporaries are about four times the draws' bytes)
HASH_CHUNK = 1 << 25


# ---------------------------------------------------------------------------
# Representation
# ---------------------------------------------------------------------------

def stack_tt(tt: TensorTrain):
    """(first, interior, last) stacked view of a uniform TensorTrain."""
    d = len(tt.cores)
    if d < 3:
        raise ValueError("uniform engine needs d >= 3")
    shapes = {tuple(C.shape) for C in tt.cores[1:-1]}
    if len(shapes) != 1:
        raise ValueError(f"interior cores not uniform: {shapes}")
    return tt.cores[0], torch.stack(tt.cores[1:-1]), tt.cores[-1]


def unstack_tt(first, interior, last) -> TensorTrain:
    cores = [first] + [interior[i] for i in range(interior.shape[0])] + [last]
    return TensorTrain(cores)


def is_uniform(tt: TensorTrain) -> bool:
    if len(tt.cores) < 3:
        return False
    shapes = {tuple(C.shape) for C in tt.cores[1:-1]}
    return len(shapes) == 1


def _hash_normal_rows(start: int, count: int, cols: int, seed, dtype,
                      device) -> torch.Tensor:
    """(count, cols) standard normals of the counter-based hash family at
    global row counters ``start .. start+count``, generated in chunks of
    rows (the same counters, so the same values, as one call)."""
    out = torch.empty((count, cols), dtype=dtype, device=device)
    step = max(1, HASH_CHUNK // max(cols, 1))
    for lo in range(0, count, step):
        hi = min(count, lo + step)
        ids = torch.arange(start + lo, start + hi, dtype=torch.int64,
                           device=device)[None, :]
        out[lo:hi] = inds_to_normal(ids, (start + count,), 0, cols, seed,
                                    dtype=dtype)
    return out


def uniform_random_tt(
    d: int,
    n: int,
    rank: int,
    seed: int,
    norm_goal: str = "norm-1",
    dtype=None,
    stream: str = "torch",
    device=None,
):
    """Stacked random TT (one generation per piece for any d).

    ``stream="torch"``: a ``torch.Generator`` on ``device`` seeded with
    ``seed``, one draw each for first, interior and last.
    ``stream="hash"``: the library's counter-based hash family at
    consecutive global row counters with per-column salts, the stream every
    DRM uses and the one the order-scaling record runs; the counters are
    the JAX package's.  ``stream="jax"`` (the JAX package's PRNG) has no
    counterpart and raises ``ValueError``.
    """
    dtype = dtype or DEFAULT_DTYPE
    device = resolve_device(device)
    if stream == "hash":
        n_int = (d - 2) * rank * n
        first = _hash_normal_rows(0, n, rank, seed, dtype, device).reshape(
            1, n, rank)
        interior = _hash_normal_rows(n, n_int, rank, seed, dtype,
                                     device).reshape(d - 2, rank, n, rank)
        last = _hash_normal_rows(n + n_int, rank * n, 1, seed, dtype,
                                 device).reshape(rank, n, 1)
    elif stream == "torch":
        gen = torch.Generator(device=device).manual_seed(int(seed))
        first = torch.randn((1, n, rank), generator=gen, dtype=dtype,
                            device=device)
        interior = torch.randn((d - 2, rank, n, rank), generator=gen,
                               dtype=dtype, device=device)
        last = torch.randn((rank, n, 1), generator=gen, dtype=dtype,
                           device=device)
    elif stream == "jax":
        raise ValueError(
            "stream 'jax' (the JAX package's PRNG) cannot be reproduced in "
            "torch; use stream 'torch' (a torch.Generator) or 'hash' (the "
            "counter-based DRM stream, equal to the JAX package's)")
    else:
        raise ValueError(f"unknown stream {stream!r}")
    if norm_goal == "norm-1":
        first = first / float(np.sqrt(n))
        interior = interior / float(np.sqrt(rank * n))
        last = last / float(np.sqrt(rank * n))
    elif norm_goal == "norm-preserve":
        interior = interior / float(np.sqrt(rank))
        last = last / float(np.sqrt(rank))
    else:
        raise ValueError(norm_goal)
    return first, interior, last


def uniform_exp_decay_tt(
    d: int, n: int, rank: int, seed: int, min_svdval: float = -20.0,
    dtype=None, device=None,
):
    """Uniform analog of the reference's ``tt_exp_decay`` test tensor:
    random cores whose unfolding spectra are replaced by
    ``logspace(0, min_svdval) * sqrt(min_dim)``.

    Generated on the host with numpy (RNG and batched SVD) exactly as the
    JAX package generates it, so equal seeds give the same cores, with one
    upload per piece."""
    dtype = dtype or DEFAULT_DTYPE
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def respectrum(mats):
        U, S, Vt = np.linalg.svd(np.asarray(mats, np.float64),
                                 full_matrices=False)
        k = S.shape[-1]
        S_new = np.logspace(0.0, min_svdval, k) * np.sqrt(k)
        return (U * S_new[None, :]) @ Vt

    def upload(values, shape):
        return torch.from_numpy(values).to(device=device,
                                           dtype=dtype).reshape(shape)

    first = upload(respectrum(rng.standard_normal((n, rank))), (1, n, rank))
    int_mats = rng.standard_normal((d - 2, rank, n * rank))
    interior = upload(respectrum(int_mats), (d - 2, rank, n, rank))
    del int_mats
    last = upload(respectrum(rng.standard_normal((rank, n))), (rank, n, 1))
    return first, interior, last


# ---------------------------------------------------------------------------
# Chain loops
# ---------------------------------------------------------------------------

def _chain_step(state, Xc, Yc):
    tmp = torch.einsum("ij,ikl->jkl", state, Xc)
    return torch.einsum("jkl,jkm->lm", tmp, Yc)


def _chain_scan(first_state, X_int, Y_int):
    """All left-chain states: state_μ = contraction of cores 0..μ of X and Y.

    Returns stacked states of shape (d-1, r_x, r_y)."""
    states = first_state.new_empty((X_int.shape[0] + 1,) + first_state.shape)
    states[0] = first_state
    state = first_state
    for i in range(X_int.shape[0]):
        state = _chain_step(state, X_int[i], Y_int[i])
        states[i + 1] = state
    return states


def _reverse_cores(first, interior, last):
    """Stacked cores of the mode-reversed TT."""
    return (
        last.permute(2, 1, 0),
        interior.flip(0).permute(0, 3, 2, 1),
        first.permute(2, 1, 0),
    )


def _right_states(X_first, X_int, X_last, Z_first, Z_int):
    """Right chain over the reversed tensor, flipped to per-edge order:
    entry μ covers modes μ+1..d-1."""
    Xr_first, Xr_int, _ = _reverse_cores(X_first, X_int, X_last)
    R0 = torch.einsum("ank,anl->kl", Xr_first, Z_first)
    return _chain_scan(R0, Xr_int, Z_int).flip(0)


# ---------------------------------------------------------------------------
# Streaming sketch + recovery
# ---------------------------------------------------------------------------

def uniform_stream_sketch_stacked(X, Y, Z):
    """Ψ/Ω of uniform TT ``X`` against left DRM ``Y`` and right DRM ``Z``.

    ``X``/``Y``/``Z`` are (first, interior, last)-style triples; ``Y`` and
    ``Z`` need only d-1 cores: Y = (first, interior[d-2]) over the original
    shape, Z likewise over the reversed shape.  Matches the generic engine
    with ``TensorTrainDRM`` cores up to float order.
    """
    X_first, X_int, X_last = X
    Y_first, Y_int = Y
    Z_first, Z_int = Z

    L0 = torch.einsum("ank,anl->kl", X_first, Y_first)
    left_states = _chain_scan(L0, X_int, Y_int)            # (d-1, r_t, r_l)
    right_states = _right_states(X_first, X_int, X_last, Z_first, Z_int)

    # Ω_μ = L_μᵀ R_μ, batched over all edges
    Omegas = torch.einsum("aji,ajk->aik", left_states, right_states)

    Psi_first = torch.einsum("ank,kl->anl", X_first, right_states[0])
    Psi_int = torch.einsum(
        "aji,ajkl,alm->aikm", left_states[:-1], X_int, right_states[1:]
    )
    Psi_last = torch.einsum("ji,jnk->ink", left_states[-1], X_last)
    return (Psi_first, Psi_int, Psi_last), Omegas


def uniform_assemble(Psis, Omegas, direction: str = "right"):
    """Recover stacked TT cores from stacked Ψ/Ω: one batched least-squares
    solve over all edges (``utils._lstsq``)."""
    Psi_first, Psi_int, Psi_last = Psis

    def solve_right(Psi, Omega):
        # Psi (..., r1, n, r2), Omega (..., l, r2): Psi Ω⁺
        r1, n, r2 = Psi.shape[-3:]
        lead = Psi.shape[:-3]
        sol = _lstsq(Omega.mT, Psi.reshape(lead + (r1 * n, r2)).mT)
        return sol.mT.reshape(lead + (r1, n, Omega.shape[-2]))

    def solve_left(Omega, Psi):
        # Omega (..., l, r1), Psi (..., l, n, r2): Ω⁺ Psi
        r1, n, r2 = Psi.shape[-3:]
        lead = Psi.shape[:-3]
        sol = _lstsq(Omega, Psi.reshape(lead + (r1, n * r2)))
        return sol.reshape(lead + (Omega.shape[-1], n, r2))

    if direction == "right":
        first = solve_right(Psi_first, Omegas[0])
        interior = solve_right(Psi_int, Omegas[1:])
        return first, interior, Psi_last
    if direction == "left":
        interior = solve_left(Omegas[:-1], Psi_int)
        last = solve_left(Omegas[-1], Psi_last)
        return Psi_first, interior, last
    raise ValueError(direction)


def _drm_pair(d, n, left_rank, right_rank, seed, dtype, stream, device):
    """The (first, interior) cores of the left and right DRMs: norm-
    preserving random TTs, the right one from the derived seed."""
    from tt_sketch_torch.engine.sketch import _derive_right_seed

    Yf, Yi, _ = uniform_random_tt(
        d, n, left_rank, seed, norm_goal="norm-preserve", dtype=dtype,
        stream=stream, device=device,
    )
    Zf, Zi, _ = uniform_random_tt(
        d, n, right_rank, _derive_right_seed(seed, d),
        norm_goal="norm-preserve", dtype=dtype, stream=stream, device=device,
    )
    return (Yf, Yi), (Zf, Zi)


def _recovery_direction(left_rank, right_rank):
    """The side whose DRM rank is the larger solves the Ω systems."""
    return "left" if left_rank > right_rank else "right"


def _stacked_input(tt: TensorTrain, dtype):
    first, interior, last = stack_tt(tt)
    dtype = dtype or first.dtype
    X = (first.to(dtype), interior.to(dtype), last.to(dtype))
    return X, dtype, interior.shape[0] + 2, first.shape[1]


def uniform_stream_sketch(
    tt: TensorTrain,
    left_rank: int,
    right_rank: int,
    seed: int,
    dtype=None,
    drm_stream: str = "torch",
) -> Tuple[TensorTrain, tuple]:
    """High-level uniform STTA: sketch + recovery on ``tt``'s device.

    DRM cores are norm-preserving random TTs (``TensorTrainDRM``'s
    distribution) from ``drm_stream`` (``uniform_random_tt``'s streams).
    Returns the recovered TensorTrain and the stacked ``(Psis, Omegas)``.
    """
    X, dtype, d, n = _stacked_input(tt, dtype)
    Y, Z = _drm_pair(d, n, left_rank, right_rank, seed, dtype, drm_stream,
                     X[0].device)
    Psis, Omegas = uniform_stream_sketch_stacked(X, Y, Z)
    del Y, Z
    rec = uniform_assemble(Psis, Omegas,
                           _recovery_direction(left_rank, right_rank))
    return unstack_tt(*rec), (Psis, Omegas)


# ---------------------------------------------------------------------------
# Orthogonalization / rounding / norms
# ---------------------------------------------------------------------------

def uniform_orthogonalize(first, interior, last):
    """LR QR sweep.

    If the first core is rank-deficient (n < r), Q/R are zero-padded back to
    rank r so every step keeps the same shapes; the factorization
    ``first = Q·R`` stays exact (zero columns times zero rows)."""
    r = first.shape[2]
    n = first.shape[1]
    Q0, R0 = torch.linalg.qr(first.reshape(n, r))
    if Q0.shape[1] < r:
        k = Q0.shape[1]
        Q0 = torch.cat([Q0, Q0.new_zeros((n, r - k))], dim=1)
        R0 = torch.cat([R0, R0.new_zeros((r - k, r))], dim=0)
    R = R0
    first_q = Q0.reshape(1, n, r)

    interior_q = torch.empty_like(interior)
    for i in range(interior.shape[0]):
        C = torch.einsum("ij,jkl->ikl", R, interior[i])
        Q, R = torch.linalg.qr(C.reshape(-1, C.shape[2]))
        interior_q[i] = Q.reshape(C.shape[0], C.shape[1], -1)
    last_q = torch.einsum("ij,jkl->ikl", R, last)
    return first_q, interior_q, last_q


def _topk_svd(C2d, k):
    """Top-k left vectors, values and right vectors of a wide matrix: a
    thin SVD (LAPACK on the CPU, cuSOLVER on CUDA)."""
    U, S, Vh = torch.linalg.svd(C2d, full_matrices=False)
    return U[:, :k], S[:k], Vh[:k, :]


def uniform_round_fixed(first, interior, last, max_rank: int):
    """LR orthogonalize + RL fixed-rank SVD truncation, both as loops.

    ``max_rank`` must satisfy max_rank <= rank and <= n (static shapes)."""
    return _truncate_fixed(*uniform_orthogonalize(first, interior, last),
                           max_rank)


def _truncate_fixed(first, interior, last, max_rank: int):
    """The RL fixed-rank SVD truncation of ``uniform_round_fixed``, on a
    TT that ``uniform_orthogonalize`` has made left-orthogonal: one
    orthogonalization can serve truncations to several ranks."""
    r = interior.shape[1] if interior.shape[0] else first.shape[2]
    n = first.shape[1]
    k = max_rank
    if k > min(r, n):
        raise ValueError(
            f"max_rank={k} must be <= min(rank={r}, mode size={n}) "
            "(static shapes)"
        )

    U, S, Vt = _topk_svd(last.reshape(last.shape[0], n), k)
    last_new = Vt.reshape(k, n, 1)
    US = U * S[None, :]  # (r, k)

    interior_new = interior.new_empty((interior.shape[0], k, n, k))
    for i in reversed(range(interior.shape[0])):
        # C: (r, n, r) · US (r, k) -> top-k svd of (r, n*k)
        C = torch.einsum("ijk,kl->ijl", interior[i], US)
        U, S, Vt = _topk_svd(C.reshape(C.shape[0], -1), k)
        interior_new[i] = Vt.reshape(k, C.shape[1], C.shape[2])
        US = U * S[None, :]
    first_new = torch.einsum("ijk,kl->ijl", first, US)
    return first_new, interior_new, last_new


def uniform_dot(A, B) -> torch.Tensor:
    """Inner product of two uniform TTs, a 0-d tensor on their device."""
    Af, Ai, Al = A
    Bf, Bi, Bl = B
    state = torch.einsum("ank,anl->kl", Af, Bf)
    for i in range(Ai.shape[0]):
        state = _chain_step(state, Ai[i], Bi[i])
    return torch.einsum("ij,ikl,jkl->", state, Al, Bl)


def uniform_norm(first, interior, last) -> torch.Tensor:
    _, _, last_q = uniform_orthogonalize(first, interior, last)
    return torch.linalg.norm(last_q)


def uniform_add(A, B):
    """Direct-sum addition of two uniform TTs (stays stacked)."""
    Af, Ai, Al = A
    Bf, Bi, Bl = B
    d2, ra, n, _ = Ai.shape
    rb = Bi.shape[1]
    first = torch.cat([Af, Bf], dim=2)
    interior = Ai.new_zeros((d2, ra + rb, n, ra + rb))
    interior[:, :ra, :, :ra] = Ai
    interior[:, ra:, :, ra:] = Bi
    last = torch.cat([Al, Bl], dim=0)
    return first, interior, last


def _rel_error_exact(A, B) -> float:
    """‖A−B‖/‖B‖ from the direct sum and its orthogonalized norm (a QR
    loop over the modes)."""
    Bf, Bi, Bl = B
    diff = uniform_add(A, (Bf, Bi, -Bl))
    return float(uniform_norm(*diff) / uniform_norm(Bf, Bi, Bl))


def _rel_error_gram(A, B) -> float:
    """‖A−B‖/‖B‖ from the Gram identity ‖A−B‖² = <A,A> − 2<A,B> + <B,B>:
    three dot loops without a QR per step, at the cost of cancellation (the
    error keeps about ``sqrt(eps)``-relative accuracy of ‖B‖)."""
    aa = float(uniform_dot(A, A))
    ab = float(uniform_dot(A, B))
    bb = float(uniform_dot(B, B))
    return float(np.sqrt(max(aa - 2.0 * ab + bb, 0.0) / bb))


def uniform_rel_error(A, B) -> float:
    """Relative error ‖A−B‖/‖B‖, by the JAX package's choice of route for
    the device: the exact direct sum on the CPU, the Gram identity off it
    (CUDA)."""
    if B[0].device.type == "cpu":
        return _rel_error_exact(A, B)
    return _rel_error_gram(A, B)


# ---------------------------------------------------------------------------
# HMT and OTTS (sequential loops with a QR per step)
# ---------------------------------------------------------------------------

def _orth_sweep(X_first, X_int, X_last, right_states, first_core, solve):
    """The forward sweep shared by HMT and OTTS: each interior core is the
    Q of ``solve(Ψ_μ, μ)``, where Ψ_μ's left side is the contraction of the
    cores orthogonalized so far; the last core absorbs the final state."""
    state = torch.einsum("ank,anl->kl", X_first, first_core)
    interior = None
    for i in range(X_int.shape[0]):
        Xc = X_int[i]
        Psi = torch.einsum("ji,jkl,lm->ikm", state, Xc, right_states[i + 1])
        Q, _ = torch.linalg.qr(solve(Psi.reshape(-1, Psi.shape[2]), i + 1))
        core = Q.reshape(Psi.shape[0], Psi.shape[1], -1)
        if interior is None:
            interior = core.new_empty((X_int.shape[0],) + core.shape)
        interior[i] = core
        state = _chain_step(state, Xc, core)
    last_core = torch.einsum("ji,jnk->ink", state, X_last)
    return first_core, interior, last_core


def uniform_hmt_sketch_stacked(X, Z):
    """One-sided HMT sweep for a uniform TT: right chain precomputed, then
    a forward loop carrying the orthogonalized left chain."""
    X_first, X_int, X_last = X
    Z_first, Z_int = Z
    n = X_first.shape[1]
    right_states = _right_states(X_first, X_int, X_last, Z_first, Z_int)

    Psi0 = torch.einsum("ank,kl->anl", X_first, right_states[0])
    Q0, _ = torch.linalg.qr(Psi0.reshape(n, -1))
    return _orth_sweep(X_first, X_int, X_last, right_states,
                       Q0.reshape(1, n, -1), lambda Psi, mu: Psi)


def uniform_orthogonal_sketch_stacked(X, Y, Z):
    """Two-sided orthogonal sweep (OTTS) for a uniform TT.

    Ω_μ = L_μᵀ R_μ from the left/right DRM chains is batched; the Ψ sweep
    is sequential: Ψ_μ's left side is the contraction of the
    already-orthogonalized cores, and each interior core is
    ``QR(Ψ_μ Ω_μ⁺)`` so the recovered TT carries the left ranks.  Requires
    right rank > left rank (the solve maps r → l) and left rank ≤ n
    (full-column-rank QR)."""
    X_first, X_int, X_last = X
    Y_first, Y_int = Y
    Z_first, Z_int = Z
    n = X_first.shape[1]

    L0 = torch.einsum("ank,anl->kl", X_first, Y_first)
    left_states = _chain_scan(L0, X_int, Y_int)  # (d-1, r_t, l)
    right_states = _right_states(X_first, X_int, X_last, Z_first, Z_int)
    Omegas = torch.einsum("aji,ajk->aik", left_states, right_states)
    del left_states

    Psi0 = torch.einsum("ank,kl->anl", X_first, right_states[0])  # (1, n, r)
    M0 = right_mul_pinv(Psi0.reshape(n, -1), Omegas[0])  # (n, l)
    Q0, _ = torch.linalg.qr(M0)
    return _orth_sweep(X_first, X_int, X_last, right_states,
                       Q0.reshape(1, n, -1),
                       lambda Psi, mu: right_mul_pinv(Psi, Omegas[mu]))


def uniform_orthogonal_sketch(
    tt: TensorTrain,
    left_rank: int,
    right_rank: int,
    seed: int,
    dtype=None,
    drm_stream: str = "torch",
) -> TensorTrain:
    """High-level uniform OTTS on ``tt``'s device.  DRMs as in
    ``uniform_stream_sketch``."""
    if right_rank <= left_rank:
        raise ValueError("orthogonal sketch needs right_rank > left_rank")
    X, dtype, d, n = _stacked_input(tt, dtype)
    if left_rank > n:
        raise ValueError("uniform OTTS needs left_rank <= mode size")
    Y, Z = _drm_pair(d, n, left_rank, right_rank, seed, dtype, drm_stream,
                     X[0].device)
    return unstack_tt(*uniform_orthogonal_sketch_stacked(X, Y, Z))


def uniform_hmt_sketch(
    tt: TensorTrain, rank: int, seed: int, dtype=None,
    drm_stream: str = "torch",
) -> TensorTrain:
    """High-level uniform HMT on ``tt``'s device (one right DRM of
    ``rank`` from ``seed``)."""
    X, dtype, d, n = _stacked_input(tt, dtype)
    Zf, Zi, _ = uniform_random_tt(
        d, n, rank, seed, norm_goal="norm-preserve", dtype=dtype,
        stream=drm_stream, device=X[0].device,
    )
    return unstack_tt(*uniform_hmt_sketch_stacked(X, (Zf, Zi)))
