"""Sharded sketches over ``torch.distributed``: one process per device,
one ``all_reduce`` per sketch.

Counterpart of ``tt_sketch_tpu/dist/sharded.py``.  The scaling axes of a
``Mesh`` (``dist/multihost.py``):

- **data axis**: the nonzeros of a sparse tensor, the mode-0 slabs of a
  dense one or the summands of a TT sum are cut into equal blocks; each
  rank sketches its own block on its own device, and the partial (Ψ, Ω)
  add up to the whole tensor's sketch because the sketch is linear in the
  tensor.
- **rank axes**: the left and right DRM ranks are cut into equal blocks;
  each rank sketches with its block of the DRMs (``DRM.slice``, the
  blocked-sketch decomposition: the hash DRMs' column salts start at the
  block's offset, so no DRM is communicated), places its blocks at their
  offsets in zero containers, and keeps the edge cores only at coordinate
  0 of their rank axis.

Every rank of the mesh calls an entry point with the same host arguments
and uploads only its own block (``make_global``).  The partial Ψ and Ω are
flattened into one buffer and summed by one ``all_reduce(SUM)`` over the
mesh, so every rank returns the whole ``SketchedTensorTrain``, as the JAX
package's ``psum`` with ``out_specs=P()`` does.  The sum's order is the
collective's, so a sharded sketch equals the single-device one up to the
order of summation.  Without a process group (one process, a mesh of one
rank) nothing is communicated.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tt_sketch_torch import profiling
from tt_sketch_torch.config import DEFAULT_DTYPE, resolve_device
from tt_sketch_torch.dist.multihost import Mesh, P, make_global
from tt_sketch_torch.drm.sparse_gaussian_drm import (
    KERNEL_DTYPES,
    SparseGaussianDRM,
)
from tt_sketch_torch.drm.tensor_train_drm import TensorTrainDRM
from tt_sketch_torch.engine.dispatch import SketchMethod, general_sketch
from tt_sketch_torch.engine.sketch import (
    SketchedTensorTrain,
    _derive_right_seed,
)
from tt_sketch_torch.engine.sketch_container import SketchContainer
from tt_sketch_torch.formats.sparse import SparseTensor
from tt_sketch_torch.formats.tensor_train import TensorTrain
from tt_sketch_torch.kernels.dense_engine import dense_stream_sketch_bisect
from tt_sketch_torch.kernels.sketch_kernels import (
    sparse_fused_applies,
    sparse_streaming_sketch_fused,
)
from tt_sketch_torch.kernels.sparse_plan import build_shard_psi_plans
from tt_sketch_torch.rng.hash_rng import hash_int
from tt_sketch_torch.utils import TTRank, process_tt_rank


def _axis_size(mesh: Mesh, axis: Optional[str]) -> int:
    return 1 if axis is None else mesh.shape[axis]


def _axis_index(mesh: Mesh, axis: Optional[str]) -> int:
    return 0 if axis is None else mesh.axis_index(axis)


def _block_sizes(rank: Tuple[int, ...], n_blocks: int) -> Tuple[int, ...]:
    for r in rank:
        if r % n_blocks != 0:
            raise ValueError(
                f"Rank {rank} must be divisible by the rank-axis size "
                f"{n_blocks}"
            )
    return tuple(r // n_blocks for r in rank)


def _pad_nnz(indices: torch.Tensor, entries: torch.Tensor, multiple: int):
    """Pad with zero entries (index 0…0): exact, since every Ψ/Ω
    contribution scales with the entry value."""
    padded = -entries.shape[0] % multiple
    if padded:
        indices = torch.cat(
            [indices, indices.new_zeros((indices.shape[0], padded))], dim=1)
        entries = torch.cat([entries, entries.new_zeros(padded)])
    return indices, entries


def _block_salts(seed: int, step: int, off: int, blk: int,
                 device=None) -> torch.Tensor:
    """int64 column salts ``hash(arange(blk) + off) + (seed + step) mod
    2^63``: the JAX package's rank-block salts, columns ``[off, off +
    blk)`` of generator step ``step``.  A DRM sliced to that block
    (``SparseGaussianDRM.slice``) hashes with the same salts, bit for
    bit."""
    seed_step = (int(seed) + int(step)) % (1 << 63)
    cols = torch.arange(blk, dtype=torch.int64, device=device) + int(off)
    return hash_int(cols) + seed_step


def _mesh_axes(mesh: Mesh, *axes: Optional[str]) -> Tuple[str, ...]:
    """The named axes, each checked to be the mesh's.  The sketch is summed
    over every rank of the mesh, so an axis of more than one rank that the
    call does not name raises (the JAX package's ``psum`` over the named
    axes would leave copies along it)."""
    used = tuple(a for a in axes if a is not None)
    for a in used:
        if a not in mesh.shape:
            raise ValueError(f"axis {a!r} is not an axis of {mesh}")
    extra = [a for a, n in mesh.shape.items() if a not in used and n > 1]
    if extra:
        raise ValueError(
            f"mesh axes {extra} are not used by this sketch; every axis of "
            f"more than one rank must be a data or rank axis")
    return used


@profiling.spanned("tt.all_reduce")
def _all_reduce_sum(mesh: Mesh, parts: Sequence[torch.Tensor]):
    """``parts`` summed over the ranks of ``mesh`` by one ``all_reduce``
    of one flat buffer (every part has one dtype and device); returned as
    views of that buffer, in the parts' shapes.  The buffer's bytes count
    as ``bytes.all_reduce``."""
    if not dist.is_initialized():
        return list(parts)
    flat = torch.cat([p.reshape(-1) for p in parts])
    profiling.count("bytes.all_reduce", flat.nbytes)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    out, off = [], 0
    for p in parts:
        out.append(flat[off: off + p.numel()].view(p.shape))
        off += p.numel()
    return out


def _rank_blocks(left_drm, right_drm, li: int, lb, rj: int, rb):
    """This rank's blocks of the DRMs: columns ``[li·lb, (li+1)·lb)`` of
    the left DRM and ``[rj·rb, (rj+1)·rb)`` of the right one, per bond."""
    return (
        left_drm.slice(tuple(li * b for b in lb),
                       tuple((li + 1) * b for b in lb)),
        right_drm.slice(tuple(rj * b for b in rb),
                        tuple((rj + 1) * b for b in rb)),
    )


def _place_blocks(Psi, Om, shape, left_rank, right_rank, li, lb, rj, rb,
                  left_rank_axis, right_rank_axis):
    """Each rank block at its offset in a zero container of the full ranks;
    the edge cores, which have no block axis on one side, only at
    coordinate 0 of that rank axis (the sum would count them once per
    coordinate otherwise)."""
    d = len(shape)
    Psi_full: List[torch.Tensor] = []
    for mu, block in enumerate(Psi):
        r1 = left_rank[mu - 1] if mu > 0 else 1
        r2 = right_rank[mu] if mu < d - 1 else 1
        full = block.new_zeros((r1, shape[mu], r2))
        o1 = li * lb[mu - 1] if mu > 0 else 0
        o2 = rj * rb[mu] if mu < d - 1 else 0
        dropped = ((mu == 0 and left_rank_axis is not None and li != 0)
                   or (mu == d - 1 and right_rank_axis is not None
                       and rj != 0))
        if not dropped:
            full[o1: o1 + block.shape[0], :, o2: o2 + block.shape[2]] = block
        Psi_full.append(full)
    Om_full: List[torch.Tensor] = []
    for mu, block in enumerate(Om):
        full = block.new_zeros((left_rank[mu], right_rank[mu]))
        full[li * lb[mu]: (li + 1) * lb[mu],
             rj * rb[mu]: (rj + 1) * rb[mu]] = block
        Om_full.append(full)
    return Psi_full, Om_full


def _reduced_sketch(mesh, Psi, Om, shape, left_rank, right_rank, left_drm,
                    right_drm) -> SketchedTensorTrain:
    d = len(shape)
    parts = _all_reduce_sum(mesh, list(Psi) + list(Om))
    container = SketchContainer(parts[:d], parts[d:], shape, left_rank,
                                right_rank)
    return SketchedTensorTrain(container, left_drm, right_drm)


def _host_entries(tensor: SparseTensor, dtype) -> np.ndarray:
    """The entries as a host array in ``dtype`` (bfloat16 values held in
    float32, which numpy has)."""
    ent = tensor.entries.detach().to(dtype)
    if dtype == torch.bfloat16:
        ent = ent.to(torch.float32)
    return ent.cpu().numpy()


def make_sharded_sparse_sketcher(
    tensor: SparseTensor,
    left_rank: Tuple[int, ...],
    right_rank: Tuple[int, ...],
    mesh: Mesh,
    data_axis: str,
    dtype,
    plan_threshold: int,
    plan_chunk: Optional[int],
    left_rank_axis: Optional[str] = None,
    right_rank_axis: Optional[str] = None,
    device=None,
):
    """Prepare-once factory for the fused sharded sparse sketch.

    Builds the per-shard plans (``build_shard_psi_plans``: the plans of
    every shard from the host arrays, as the JAX package does) and uploads
    this rank's nnz shard and plans once; returns ``sketch(left_drm,
    right_drm) -> SketchedTensorTrain``, which can be called again with
    fresh seeds.  The DRMs are a float32/bfloat16 pair of hash-family DRMs
    on this rank's device, at ``left_rank``/``right_rank``.

    Each call sketches the rank's shard with its rank blocks of the DRMs
    through ``sparse_streaming_sketch_fused``, which takes per mode the
    branch the JAX package's shard program takes: the merged Ψ+Ω kernel
    where the plan carries the inclusive prefix, the fused Ψ kernel (or
    the window kernel) for another plan, ``lazy_gaussian`` rows and the
    segment reduction for a mode without a plan, then the fused Ω kernel
    for every Ω not merged.  Blocks are placed at their offsets and one
    ``all_reduce`` gives every rank the whole sketch.
    """
    device = resolve_device(device)
    shape = tuple(tensor.shape)
    _mesh_axes(mesh, data_axis, left_rank_axis, right_rank_axis)
    n_data = mesh.shape[data_axis]
    lb = _block_sizes(left_rank, _axis_size(mesh, left_rank_axis))
    rb = _block_sizes(right_rank, _axis_size(mesh, right_rank_axis))
    rank_split = left_rank_axis is not None or right_rank_axis is not None
    li = _axis_index(mesh, left_rank_axis)
    rj = _axis_index(mesh, right_rank_axis)

    idx_shards, ent_shards, shard_plans = build_shard_psi_plans(
        tensor.indices.detach().cpu().numpy(), _host_entries(tensor, dtype),
        shape, n_data, threshold=plan_threshold, chunk=plan_chunk,
        device="cpu",
    )
    plans = tuple(
        None if p is None else p.to(device).map_entries(lambda e: e.to(dtype))
        for p in shard_plans[mesh.axis_index(data_axis)]
    )
    shard = SparseTensor(
        shape, make_global(mesh, P(data_axis), idx_shards, device)[0],
        make_global(mesh, P(data_axis), ent_shards, device)[0].to(dtype),
        psi_plan=plans,
    )

    def sketch(left_drm, right_drm) -> SketchedTensorTrain:
        lblk, rblk = _rank_blocks(left_drm, right_drm, li, lb, rj, rb)
        if not sparse_fused_applies(shard, lblk, rblk):
            raise ValueError(
                "the sharded sparse sketcher takes a float32/bfloat16 pair "
                "of hash-family DRMs of the tensor's dtype")
        Psi, Om = sparse_streaming_sketch_fused(shard, lblk, rblk)
        if rank_split:
            Psi, Om = _place_blocks(Psi, Om, shape, left_rank, right_rank,
                                    li, lb, rj, rb, left_rank_axis,
                                    right_rank_axis)
        return _reduced_sketch(mesh, Psi, Om, shape, left_rank, right_rank,
                               left_drm, right_drm)

    return sketch


def _sharded_sparse_fused(
    tensor: SparseTensor,
    left_rank: Tuple[int, ...],
    right_rank: Tuple[int, ...],
    left_seed: int,
    right_seed: int,
    mesh: Mesh,
    data_axis: str,
    dtype,
    plan_threshold: int,
    plan_chunk: Optional[int],
    left_rank_axis: Optional[str] = None,
    right_rank_axis: Optional[str] = None,
    device=None,
) -> SketchedTensorTrain:
    """One-shot wrapper over :func:`make_sharded_sparse_sketcher`."""
    device = resolve_device(device)
    sketch = make_sharded_sparse_sketcher(
        tensor, left_rank, right_rank, mesh, data_axis, dtype,
        plan_threshold, plan_chunk, left_rank_axis, right_rank_axis, device,
    )
    left_drm = SparseGaussianDRM(
        left_rank, shape=tensor.shape, transpose=False, seed=left_seed,
        dtype=dtype, device=device,
    )
    right_drm = SparseGaussianDRM(
        right_rank, shape=tensor.shape, transpose=True, seed=right_seed,
        dtype=dtype, device=device,
    )
    return sketch(left_drm, right_drm)


def _seeds(seed: int, d: int) -> Tuple[int, int]:
    return (int(seed % (2 ** 32 - 1)),
            int(_derive_right_seed(seed, d) % (2 ** 32 - 1)))


def _ranks(left_rank, right_rank, shape):
    right_bigger = bool(np.all(np.array(left_rank) < np.array(right_rank)))
    return (process_tt_rank(left_rank, shape, trim=right_bigger),
            process_tt_rank(right_rank, shape, trim=not right_bigger))


def sharded_sparse_stream_sketch(
    tensor: SparseTensor,
    left_rank: TTRank,
    right_rank: TTRank,
    seed: int,
    mesh: Mesh,
    data_axis: Optional[str] = "data",
    left_rank_axis: Optional[str] = None,
    right_rank_axis: Optional[str] = None,
    dtype=None,
    plan_threshold: int = 512,
    plan_chunk: Optional[int] = None,
    device=None,
) -> SketchedTensorTrain:
    """Streaming sketch of a COO tensor sharded over a mesh of ranks.

    Equals ``stream_sketch(tensor, ..., SparseGaussianDRM)`` on one device
    up to the order of summation.  ``data_axis`` shards the nonzeros;
    ``left_rank_axis``/``right_rank_axis`` shard the DRM ranks.  Every rank
    passes the same ``tensor`` (its arrays are read on the host) and gets
    the whole sketch on ``device`` (default: the package default).

    In float32/bfloat16 with a data axis each shard runs the fused kernels
    with plans built per shard (``plan_threshold``/``plan_chunk`` go to the
    planner; ``make_sharded_sparse_sketcher``).  Otherwise (float64, or no
    data axis) each rank sketches its nnz block, zero-padded to a multiple
    of the data axis, with its rank blocks of the DRMs through the
    streaming engine: per-block rows and the segment reduction.  The DRMs
    pick their rows by dtype, as everywhere in the port, so float32 rows
    follow the kernel contract there too (the JAX package's plain branch
    takes the parity rows rounded to float32).
    """
    dtype = dtype or DEFAULT_DTYPE
    device = resolve_device(device)
    shape = tuple(tensor.shape)
    d = len(shape)
    left_rank, right_rank = _ranks(left_rank, right_rank, shape)
    left_seed, right_seed = _seeds(seed, d)

    if data_axis is not None and dtype in KERNEL_DTYPES:
        return _sharded_sparse_fused(
            tensor, left_rank, right_rank, left_seed, right_seed,
            mesh, data_axis, dtype, plan_threshold, plan_chunk,
            left_rank_axis=left_rank_axis, right_rank_axis=right_rank_axis,
            device=device,
        )

    _mesh_axes(mesh, data_axis, left_rank_axis, right_rank_axis)
    n_data = _axis_size(mesh, data_axis)
    lb = _block_sizes(left_rank, _axis_size(mesh, left_rank_axis))
    rb = _block_sizes(right_rank, _axis_size(mesh, right_rank_axis))
    li = _axis_index(mesh, left_rank_axis)
    rj = _axis_index(mesh, right_rank_axis)

    indices, entries = _pad_nnz(tensor.indices.detach().cpu(),
                                tensor.entries.detach().cpu().to(dtype),
                                n_data)
    shard = SparseTensor(
        shape, make_global(mesh, P(None, data_axis), indices, device),
        make_global(mesh, P(data_axis), entries, device),
    )
    left_drm = SparseGaussianDRM(
        left_rank, shape=shape, transpose=False, seed=left_seed, dtype=dtype,
        device=device,
    )
    right_drm = SparseGaussianDRM(
        right_rank, shape=shape, transpose=True, seed=right_seed,
        dtype=dtype, device=device,
    )
    lblk, rblk = _rank_blocks(left_drm, right_drm, li, lb, rj, rb)
    part = general_sketch(shard, lblk, rblk, SketchMethod.streaming)
    Psi, Om = part.Psi_cores, part.Omega_mats
    if left_rank_axis is not None or right_rank_axis is not None:
        Psi, Om = _place_blocks(Psi, Om, shape, left_rank, right_rank, li,
                                lb, rj, rb, left_rank_axis, right_rank_axis)
    return _reduced_sketch(mesh, Psi, Om, shape, left_rank, right_rank,
                           left_drm, right_drm)


def _padded_rows(arr: torch.Tensor, dim: int, lo: int, n: int, device,
                 dtype) -> torch.Tensor:
    """``arr`` narrowed to ``[lo, lo + n)`` along ``dim`` on ``device`` in
    ``dtype``, zero-padded past the end of ``arr``: a block of the
    zero-padded array without copying the rest of ``arr``."""
    size = arr.shape[dim]
    start = min(lo, size)
    have = min(lo + n, size) - start
    block = arr.narrow(dim, start, have).to(device=device, dtype=dtype)
    if have < n:
        pad_shape = list(block.shape)
        pad_shape[dim] = n - have
        block = torch.cat([block, block.new_zeros(pad_shape)], dim=dim)
    return block.contiguous()


def sharded_dense_stream_sketch(
    X,
    left_rank: TTRank,
    right_rank: TTRank,
    seed: int,
    mesh: Mesh,
    data_axis: str = "data",
    dtype=None,
    device=None,
) -> SketchedTensorTrain:
    """Streaming sketch of a dense tensor sharded in mode-0 slabs.

    Every rank passes the same ``X`` (a host array, which may lie in
    shared memory: each rank copies only its slab to ``device``).  Each
    rank runs the bisected two-projection engine on its slab against the
    TT-DRM chains, with its own rows of the mode-0 left core; Ψ_0 is placed
    at the slab's offset, and one ``all_reduce`` sums the partial sketches.
    An indivisible mode 0 is zero-padded to the next multiple of the data
    axis (exact: zero rows add nothing, and Ψ_0's padded rows are sliced
    off).  A float32 slab's projections take ``dual_project`` (the kernel
    on CUDA, its plain version on the CPU); the kernel takes float32 only,
    so another dtype takes two ``torch.matmul``.
    """
    dtype = dtype or DEFAULT_DTYPE
    device = resolve_device(device)
    X = torch.as_tensor(X)
    shape = tuple(int(s) for s in X.shape)
    d = len(shape)
    left_rank, right_rank = _ranks(left_rank, right_rank, shape)
    left_seed, right_seed = _seeds(seed, d)
    _mesh_axes(mesh, data_axis)
    n_data = mesh.shape[data_axis]
    slab = -(-shape[0] // n_data)
    padded0 = slab * n_data
    lo = mesh.axis_index(data_axis) * slab

    left_drm = TensorTrainDRM(
        left_rank, shape=shape, transpose=False, seed=left_seed, dtype=dtype,
        device=device,
    )
    right_drm = TensorTrainDRM(
        right_rank, shape=shape, transpose=True, seed=right_seed,
        dtype=dtype, device=device,
    )
    core0 = _padded_rows(left_drm.cores[0], 1, lo, slab, device, dtype)
    x_slab = _padded_rows(X, 0, lo, slab, device, dtype)
    psis, omegas = dense_stream_sketch_bisect(
        x_slab, [core0] + list(left_drm.cores[1:]), right_drm.cores,
        projector="auto" if dtype == torch.float32 else "matmul",
    )
    # Ψ_0 rows belong to this slab only: place them at the slab's offset
    psi0 = psis[0].new_zeros((1, padded0, psis[0].shape[2]))
    psi0[:, lo: lo + slab] = psis[0]
    parts = _all_reduce_sum(mesh, [psi0] + list(psis[1:]) + list(omegas))
    Psi = [parts[0][:, : shape[0], :]] + parts[1:d]
    container = SketchContainer(Psi, parts[d:], shape, left_rank, right_rank)
    return SketchedTensorTrain(container, left_drm, right_drm)


def sharded_tt_sum_stream_sketch(
    summands_cores,
    shape: Tuple[int, ...],
    left_rank: TTRank,
    right_rank: TTRank,
    seed: int,
    mesh: Mesh,
    data_axis: str = "data",
    dtype=None,
    device=None,
) -> SketchedTensorTrain:
    """Streaming sketch of a sum of equal-rank TTs, summands sharded over
    the data axis.

    ``summands_cores``: a list over modes of stacked cores with a leading
    summand axis, entry μ of shape ``(n_summands, r1, n_μ, r2)`` (host
    arrays; every rank passes the same and uploads its own summands).  The
    summands are zero-padded to a multiple of the data axis (a zero summand
    sketches to zero); each rank adds the ``general_sketch`` of each of its
    summands with the TT-DRMs, and one ``all_reduce`` sums the ranks'.
    """
    dtype = dtype or DEFAULT_DTYPE
    device = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    d = len(shape)
    left_rank, right_rank = _ranks(left_rank, right_rank, shape)
    left_seed, right_seed = _seeds(seed, d)
    _mesh_axes(mesh, data_axis)

    left_drm = TensorTrainDRM(
        left_rank, shape=shape, transpose=False, seed=left_seed, dtype=dtype,
        device=device,
    )
    right_drm = TensorTrainDRM(
        right_rank, shape=shape, transpose=True, seed=right_seed,
        dtype=dtype, device=device,
    )
    stacked = [torch.as_tensor(C) for C in summands_cores]
    per = -(-stacked[0].shape[0] // mesh.shape[data_axis])
    lo = mesh.axis_index(data_axis) * per
    local = [_padded_rows(C, 0, lo, per, device, dtype) for C in stacked]

    Psi = Om = None
    for k in range(per):
        sk = general_sketch(TensorTrain([C[k] for C in local]), left_drm,
                            right_drm, SketchMethod.streaming)
        if Psi is None:
            Psi, Om = list(sk.Psi_cores), list(sk.Omega_mats)
        else:
            Psi = [a + b for a, b in zip(Psi, sk.Psi_cores)]
            Om = [a + b for a, b in zip(Om, sk.Omega_mats)]
    return _reduced_sketch(mesh, Psi, Om, shape, left_rank, right_rank,
                           left_drm, right_drm)
