"""Ψ/Ω sketch contractions for dense, TT, CP, Tucker and sparse input.

Ω_μ = Y_μᵀ X^{<μ>} Z_μ (small matrix) and Ψ_μ = Y_{μ-1}ᵀ X^{(μ)} Z_μ
(order-3 core), from the DRMs' per-mode contraction outputs.  Counterpart
of ``tt_sketch_tpu/kernels/sketch_kernels.py``.  Dense, TT, CP and Tucker
input are ``einsum``s and matrix products.

Sparse input takes two routes.  A streaming sketch with a pair of
hash-family DRMs (``SparseGaussianDRM``, ``SparseSignDRM`` or one of each)
in float32/bfloat16 goes to ``sparse_streaming_sketch_fused``: every Ψ and
Ω through the fused kernels of ``kernels/sparse_psi.py`` (DRM rows hashed
inside the kernel, per the tensor's sort/chunk plans; a giant mode's
``WindowPlan`` goes to ``psi_window_direct``) and the row generators
``kernels/lazy_gaussian.py`` / ``kernels/sparse_sign.py`` (rows of unplanned
modes).  Every other sketch (the sequential methods, whose left side is the
chain of orthogonalized cores; a ``TensorTrainDRM`` on either side; float64)
calls ``sketch_psi_sparse`` / ``sketch_omega_sparse`` per mode.  In
float32/bfloat16 with a ``ModePlan``, Ψ_μ then takes, in this order: the
fused kernel when every side it consumes is a hash DRM; the half-fused
kernel (``psi_chunk_slabs_genright``) when one side is a hash DRM and the
other an array; the grouped kernel (``psi_chunk_slabs``) over rows gathered
into the plan's order.  Without a plan, with a ``WindowPlan`` and a non-hash
side, or in float64 it is the segment reduction over materialized rows
(``kernels/segment_psi.py``).
"""
from __future__ import annotations

import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.kernels.lazy_gaussian import lazy_gaussian
from tt_sketch_torch.kernels.segment_psi import (
    psi_dtype,
    psi_segment,
    psi_segment_reference,
    segment_fits,
)
from tt_sketch_torch.kernels.sparse_plan import WindowPlan
from tt_sketch_torch.kernels.sparse_psi import (
    omega_fused,
    psi_chunk_slabs,
    psi_chunk_slabs_genright,
    psi_fused_slabs,
    psi_omega_merged_slabs,
    psi_window_direct,
)
from tt_sketch_torch.kernels.sparse_sign import sparse_sign_rows
from tt_sketch_torch.rng.hash_rng import flat_index
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


# -- CP ----------------------------------------------------------------------

def sketch_omega_cp(left_sketch, right_sketch, **kwargs):
    return left_sketch.T @ right_sketch


def sketch_psi_cp(left_sketch, right_sketch, *, tensor, mu, **kwargs):
    factor = tensor.cores[mu]  # (n_mu, cp_rank)
    if left_sketch is None:
        return torch.einsum("ji,il->jl", factor, right_sketch)[None, :, :]
    if right_sketch is None:
        return torch.einsum("il,kl->ik", left_sketch.T, factor)[:, :, None]
    # Ψ[i,k,m] = Σ_j L[j,i] · factor[k,j] · R[j,m]
    tmp = left_sketch.T[:, None, :] * factor[None, :, :]  # (i, k, j)
    return torch.einsum("ikj,jm->ikm", tmp, right_sketch)


# -- Tucker ------------------------------------------------------------------

def sketch_omega_tucker(left_sketch, right_sketch, *, tensor, mu, **kwargs):
    core_mat = matricize(tensor.core, tuple(range(mu + 1)), mat_shape=True)
    return left_sketch.T @ core_mat @ right_sketch


def sketch_psi_tucker(left_sketch, right_sketch, *, tensor, mu, **kwargs):
    left_dim = left_sketch.shape[0] if left_sketch is not None else 1
    right_dim = right_sketch.shape[0] if right_sketch is not None else 1
    ord3 = tensor.core.reshape(left_dim, tensor.rank[mu], right_dim)
    if left_sketch is None:
        Psi = torch.einsum("ijk,kl->ijl", ord3, right_sketch)
    elif right_sketch is None:
        Psi = torch.einsum("ij,jkl->ikl", left_sketch.T, ord3)
    else:
        tmp = torch.einsum("ij,jkl->ikl", left_sketch.T, ord3)
        Psi = torch.einsum("ikl,lm->ikm", tmp, right_sketch)
    return torch.einsum("ijk,jl->ilk", Psi, tensor.factors[mu])


# -- sparse ------------------------------------------------------------------

def _is_kernel_hash_drm(drm) -> bool:
    from tt_sketch_torch.drm.sparse_gaussian_drm import SparseGaussianDRM
    from tt_sketch_torch.drm.sparse_sign_drm import SparseSignDRM

    return (isinstance(drm, (SparseGaussianDRM, SparseSignDRM))
            and drm.uses_kernel_contract)


def _kernel_dtype(tensor) -> bool:
    from tt_sketch_torch.drm.sparse_gaussian_drm import KERNEL_DTYPES

    return tensor.dtype in KERNEL_DTYPES


def sparse_fused_applies(tensor, left_drm, right_drm) -> bool:
    """Whether ``sparse_streaming_sketch_fused`` sketches ``tensor``: both
    DRMs are kernel-contract hash-family DRMs (Gaussian, sign or one of
    each) and the tensor is float32 or bfloat16."""
    return (_kernel_dtype(tensor) and _is_kernel_hash_drm(left_drm)
            and _is_kernel_hash_drm(right_drm))


def _materialize(side):
    """Sides may arrive as thunks: the fused paths never need the rows, so
    a thunk is called only where a path consumes the array."""
    return side() if callable(side) else side


def _psi_sparse_segment(left, right, entries, indices_mu, n_mu):
    """Σ_k  e_{ind[k]} ⊗ (left[:,k]·entries[k]) ⊗ right[:,k]: the
    counterpart of the ``jax.ops.segment_sum`` the JAX package takes off a
    TPU (its one-hot product there is a TPU workaround).  A Ψ that
    ``segment_fits`` (the kernel's bins of one micro-tile of every row
    beside its smallest ring fit its shared memory) takes ``psi_segment``
    (the kernel on CUDA); a larger one, of thousands of rows, scatters with
    ``index_add_`` (``psi_segment_reference``) on every device, inside the
    span ``tt.psi_index_add`` and counted as ``fallbacks.psi_index_add``:
    its atomics then spread over that many rows.  Returns (r1, n_mu, r2)."""
    if segment_fits(left, right, n_mu, psi_dtype(left, right, entries)):
        psi = psi_segment(left, right, entries, indices_mu, n_mu)
    else:
        profiling.count("fallbacks.psi_index_add")
        with profiling.span("tt.psi_index_add"):
            psi = psi_segment_reference(left, right, entries, indices_mu,
                                        n_mu)
    return psi.permute(1, 0, 2)


def _combine_slabs(flat, plan, n_mu):
    """Slab-slot combine into the (n_mu, w) Ψ matrix: the plan's
    ``gather_slots`` row gathers (an appended zero row serves the sentinel
    slot) or an ``index_add_`` over ``slot_rows``, whose unused slots
    (``n_mu``) land in a dump row that is sliced off."""
    if plan.gather_slots is not None:
        flat_pad = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
        gs = plan.gather_slots
        psi = flat_pad[gs[:, 0]]
        for k in range(1, gs.shape[1]):
            psi = psi + flat_pad[gs[:, k]]
        return psi
    out = flat.new_zeros((n_mu + 1, flat.shape[1]))
    out.index_add_(0, plan.slot_rows, flat)
    return out[:n_mu]


def _psi_from_slabs(slabs, plan, n_mu, dtype):
    nc, S, r1, r2 = slabs.shape
    psi = _combine_slabs(slabs.reshape(nc * S, r1 * r2), plan, n_mu)
    return psi.reshape(n_mu, r1, r2).permute(1, 0, 2).to(dtype)


def _psi_sides(tensor, mu, plan, left_drm, right_drm):
    """Flat streams, salts and specs of Ψ_μ's sides: left rows are generator
    step μ-1 of the left DRM; right rows the transposed generator's step
    d-2-μ with the right DRM's (reversed) rank slice.  A missing side is
    (None, None) with the Gaussian spec."""
    d = len(tensor.shape)
    lflat = lsalts = rflat = rsalts = None
    lspec = rspec = ("g",)
    if mu > 0:
        lflat, lsalts = plan.flat_left, left_drm.salts(mu - 1)
        lspec = left_drm.side_spec(mu - 1)
    if mu < d - 1:
        rflat, rsalts = plan.flat_right, right_drm.salts(d - 2 - mu)
        rspec = right_drm.side_spec(d - 2 - mu)
    return lflat, lsalts, rflat, rsalts, lspec, rspec


def _psi_sparse_fused(tensor, mu, plan, n_mu, left_drm, right_drm):
    """Ψ_μ from the fused slab kernel at the plan's sorted order; a
    ``WindowPlan`` goes to the window kernel."""
    if isinstance(plan, WindowPlan):
        return _psi_sparse_window(tensor, mu, plan, n_mu, left_drm, right_drm)
    lflat, lsalts, rflat, rsalts, lspec, rspec = _psi_sides(
        tensor, mu, plan, left_drm, right_drm)
    slabs = psi_fused_slabs(
        plan.local_idx, plan.sorted_entries, lflat, rflat, lsalts, rsalts,
        plan.n_chunks, plan.span, plan.chunk, lspec, rspec,
    )
    return _psi_from_slabs(slabs, plan, n_mu, tensor.dtype)


def _psi_sparse_window(tensor, mu, plan, n_mu, left_drm, right_drm):
    """Ψ_μ of a giant mode from the aligned-window kernel: finished rows,
    no combine; the row padding of the last window is sliced off."""
    lflat, lsalts, rflat, rsalts, lspec, rspec = _psi_sides(
        tensor, mu, plan, left_drm, right_drm)
    psi = psi_window_direct(
        plan.chunk_window, plan.chunk_first, plan.local_idx,
        plan.sorted_entries, lflat, rflat, lsalts, rsalts, plan.n_chunks,
        plan.span, plan.chunk, plan.n_windows, lspec, rspec,
    )
    return psi[:n_mu].permute(1, 0, 2).to(tensor.dtype)


def _psi_omega_sparse_merged(tensor, mu, plan, n_mu, left_drm, right_drm):
    """Ψ_μ and Ω_μ from the merged kernel: one pass over the mode-sorted
    stream, R_μ hashed once for both; Ω's left rows are generator step μ
    over the inclusive prefix (``plan.flat_left_om``)."""
    lflat, lsalts, rflat, rsalts, lspec, rspec = _psi_sides(
        tensor, mu, plan, left_drm, right_drm)
    slabs, om = psi_omega_merged_slabs(
        plan.local_idx, plan.sorted_entries, lflat, rflat,
        plan.flat_left_om, lsalts, rsalts, left_drm.salts(mu),
        plan.n_chunks, plan.span, plan.chunk, lspec, rspec,
        left_drm.side_spec(mu),
    )
    return (_psi_from_slabs(slabs, plan, n_mu, tensor.dtype),
            om.to(tensor.dtype))


def _omega_sparse_fused(tensor, mu, left_drm, right_drm):
    """Ω_μ with both row families hashed inside the kernel, in nnz order."""
    d = len(tensor.shape)
    lflat = flat_index(tensor.indices[: mu + 1], tensor.shape[: mu + 1])
    rflat = flat_index(tensor.indices.flip(0)[: d - 1 - mu],
                       tensor.shape[::-1][: d - 1 - mu])
    om = omega_fused(tensor.entries, lflat, rflat, left_drm.salts(mu),
                     right_drm.salts(d - 2 - mu), left_drm.side_spec(mu),
                     right_drm.side_spec(d - 2 - mu))
    return om.to(tensor.dtype)


def _hash_rows_from_pairs(drm, k: int, flat, dtype):
    """(rank, N) rows of generator step ``k`` at int64 flat indices (the
    JAX package passes them as uint32 pairs, hence the name): the
    sparse-sign generator for a sign DRM, the lazy-Gaussian one otherwise."""
    spec = drm.side_spec(k)
    if spec[0] == "s":
        _, rank, nnz, rank_min, r_out = spec
        rows = sparse_sign_rows(flat, drm.salts(k), rank, nnz, rank_min,
                                rank_min + r_out)
    else:
        rows = lazy_gaussian(flat, drm.salts(k))
    return rows.to(dtype)


def sketch_omega_sparse(left_sketch, right_sketch, *, tensor, mu=None,
                        left_drm=None, right_drm=None, **kwargs):
    """Ω_μ = Σ_k entries[k] · left[:,k] ⊗ right[:,k]: the fused kernel when
    ``mu`` is given and both DRMs are kernel-contract hash DRMs (the rows
    are hashed inside it and the sides, which may be thunks, are never
    read), else the product over materialized rows."""
    if (mu is not None and _kernel_dtype(tensor)
            and _is_kernel_hash_drm(left_drm)
            and _is_kernel_hash_drm(right_drm)):
        return _omega_sparse_fused(tensor, mu, left_drm, right_drm)
    left_sketch = _materialize(left_sketch)
    right_sketch = _materialize(right_sketch)
    return (left_sketch * tensor.entries) @ right_sketch.T


def _sorted_rows(arr, plan):
    """``arr[:, plan.perm]``: an (r, nnz) row family gathered into the
    plan's mode-sorted order."""
    return arr.index_select(1, plan.perm)


def _psi_sparse_grouped(left, right, entries, plan, n_mu):
    """Ψ_μ over a sort/chunk plan from materialized rows: entries and rows
    are gathered into the plan's order, ``psi_chunk_slabs`` writes one slab
    per chunk and the slabs are combined.

    The entries are the argument's, gathered through ``plan.perm``: a plan
    whose ``sorted_entries`` went stale cannot change the result (the JAX
    package prefers ``plan.sorted_entries``; a gather costs little here)."""
    se = entries.index_select(0, plan.perm)
    sl = sr = None
    if left is not None:
        sl = _sorted_rows(left, plan).to(torch.float32)
    if right is not None:
        sr = _sorted_rows(right, plan).to(torch.float32)
    slabs = psi_chunk_slabs(plan.local_idx, se, sl, sr, plan.n_chunks,
                            plan.span, plan.chunk)
    return _psi_from_slabs(slabs, plan, n_mu, entries.dtype)


def _can_fuse_psi(plan, tensor, mu, left_drm, right_drm) -> bool:
    """The fused sorted-stream kernels apply when the plan carries the
    sorted streams and every side Ψ_μ consumes is a kernel-contract hash
    DRM (the kernel hashes the rows the DRM would materialize)."""
    if plan.sorted_entries is None or not _kernel_dtype(tensor):
        return False
    d = len(tensor.shape)
    if mu > 0 and not _is_kernel_hash_drm(left_drm):
        return False
    if mu < d - 1 and not _is_kernel_hash_drm(right_drm):
        return False
    return True


def _can_halffuse_psi(plan, tensor, mu, left_sketch, right_sketch, left_drm,
                      right_drm) -> bool:
    """Exactly one consumed side is a kernel-contract hash DRM, the other
    side's rows are present as an array (a sequential chain state or a
    materialized non-hash DRM), and the ``ModePlan`` carries the sorted
    streams."""
    if (plan.sorted_entries is None or isinstance(plan, WindowPlan)
            or not _kernel_dtype(tensor)):
        return False
    d = len(tensor.shape)
    right_hash = mu < d - 1 and _is_kernel_hash_drm(right_drm)
    left_hash = mu > 0 and _is_kernel_hash_drm(left_drm)
    if right_hash and not left_hash:
        return mu == 0 or left_sketch is not None
    if left_hash and not right_hash:
        return mu == d - 1 or right_sketch is not None
    return False


def _psi_sparse_halffused(left_sketch, right_sketch, tensor, mu, plan, n_mu,
                          left_drm, right_drm):
    """Ψ_μ with one hash-family side generated in the kernel and the other
    side's rows fed in sorted order (one gather through ``plan.perm``).

    Serves the sequential methods' chain left side and streaming's mixed
    TT-DRM × hash pairs.  The swapped case (hash left, array right) is the
    same kernel call with the roles exchanged and each slab block
    transposed."""
    d = len(tensor.shape)
    right_is_hash = mu < d - 1 and _is_kernel_hash_drm(right_drm)
    if right_is_hash:
        gen_drm, k, gen_flat = right_drm, d - 2 - mu, plan.flat_right
        arr = left_sketch
    else:
        gen_drm, k, gen_flat = left_drm, mu - 1, plan.flat_left
        arr = right_sketch
    arr = _materialize(arr)
    rows = (None if arr is None
            else _sorted_rows(arr, plan).to(torch.float32))
    slabs = psi_chunk_slabs_genright(
        plan.local_idx, plan.sorted_entries, rows, gen_flat,
        gen_drm.salts(k), plan.n_chunks, plan.span, plan.chunk,
        gen_drm.side_spec(k),
    )  # (n_chunks, span, r_arr, r_gen)
    if not right_is_hash:
        slabs = slabs.transpose(2, 3)
    return _psi_from_slabs(slabs, plan, n_mu, tensor.dtype)


def sketch_psi_sparse(left_sketch, right_sketch, *, tensor, mu,
                      left_drm=None, right_drm=None, **kwargs):
    """Ψ_μ of a sparse tensor from its sides (arrays, thunks or None) and,
    where known, the DRMs behind them (module docstring: fused, half-fused,
    grouped, segment)."""
    n_mu = tensor.shape[mu]
    plan = tensor.psi_plan[mu] if tensor.psi_plan is not None else None
    if plan is not None:
        if _can_fuse_psi(plan, tensor, mu, left_drm, right_drm):
            return _psi_sparse_fused(tensor, mu, plan, n_mu, left_drm,
                                     right_drm)
        # a WindowPlan carries only the window kernel's padded streams, and
        # float64 is the parity path: both take the segment reduction
        if not isinstance(plan, WindowPlan) and _kernel_dtype(tensor):
            if _can_halffuse_psi(plan, tensor, mu, left_sketch, right_sketch,
                                 left_drm, right_drm):
                return _psi_sparse_halffused(
                    left_sketch, right_sketch, tensor, mu, plan, n_mu,
                    left_drm, right_drm)
            return _psi_sparse_grouped(
                _materialize(left_sketch), _materialize(right_sketch),
                tensor.entries, plan, n_mu)
    return _psi_sparse_segment(
        _materialize(left_sketch), _materialize(right_sketch),
        tensor.entries, tensor.indices[mu], n_mu)


def sparse_streaming_sketch_fused(tensor, left_drm, right_drm):
    """Every Ψ and Ω of a SparseTensor with a kernel-contract hash-family
    DRM pair (Gaussian, sign or mixed), through the fused kernels and no
    materialized contraction lists.

    Per mode: the merged Ψ+Ω kernel where the plan carries the inclusive
    prefix; the fused Ψ kernel, or the window kernel for a ``WindowPlan``
    (and later the fused Ω kernel), where it does not; the segment
    reduction over lazily generated rows for modes without a plan.  Ω of
    modes not merged comes from the fused Ω kernel."""
    d = len(tensor.shape)
    dtype = tensor.dtype
    plans = tensor.psi_plan or (None,) * d

    def _lrows(k):
        flat = flat_index(tensor.indices[: k + 1], tensor.shape[: k + 1])
        return _hash_rows_from_pairs(left_drm, k, flat, dtype)

    def _rrows(kt):
        flat = flat_index(tensor.indices.flip(0)[: kt + 1],
                          tensor.shape[::-1][: kt + 1])
        return _hash_rows_from_pairs(right_drm, kt, flat, dtype)

    Psi = []
    Om = [None] * (d - 1)
    for mu in range(d):
        p = plans[mu]
        fused_psi = p is not None and p.sorted_entries is not None
        with profiling.span(f"tt.mode.{mu}"):
            if fused_psi and mu < d - 1 and p.flat_left_om is not None:
                psi_mu, Om[mu] = _psi_omega_sparse_merged(
                    tensor, mu, p, tensor.shape[mu], left_drm, right_drm)
            elif fused_psi:
                psi_mu = _psi_sparse_fused(tensor, mu, p, tensor.shape[mu],
                                           left_drm, right_drm)
            else:
                ls = _lrows(mu - 1) if mu > 0 else None
                rs = _rrows(d - 2 - mu) if mu < d - 1 else None
                psi_mu = _psi_sparse_segment(ls, rs, tensor.entries,
                                             tensor.indices[mu],
                                             tensor.shape[mu])
        Psi.append(psi_mu)
    for mu in range(d - 1):
        if Om[mu] is None:
            with profiling.span(f"tt.mode.{mu}"):
                Om[mu] = _omega_sparse_fused(tensor, mu, left_drm, right_drm)
    return Psi, Om
