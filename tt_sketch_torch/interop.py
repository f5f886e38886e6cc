"""Hand numpy arrays (e.g. the JAX package's DRM cores, sketches, sparse
data, sort/chunk plans and CP, Tucker, sum tensors and MPOs, read back with
``np.asarray``) to the port, keeping their dtype."""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from tt_sketch_torch.config import resolve_device
from tt_sketch_torch.engine.sketch_container import SketchContainer


def from_numpy_cores(cores: Sequence[np.ndarray],
                     device=None) -> List[torch.Tensor]:
    """numpy arrays → torch tensors on ``device`` (default: package
    default), same dtype and values."""
    device = resolve_device(device)
    return [torch.from_numpy(np.array(c)).to(device) for c in cores]


def container_from_numpy(psi_list: Sequence[np.ndarray],
                         omega_list: Sequence[np.ndarray],
                         device=None) -> SketchContainer:
    """A ``SketchContainer`` from numpy Ψ cores and Ω matrices."""
    return SketchContainer(
        from_numpy_cores(psi_list, device), from_numpy_cores(omega_list, device)
    )


def tt_drm_from_numpy(cores: Sequence[np.ndarray], rank, shape,
                      transpose: bool, seed: Optional[int] = None,
                      device=None, **slice_kwargs):
    """A ``TensorTrainDRM`` with the given cores (e.g. ``np.asarray`` of a
    JAX ``TensorTrainDRM``'s ``cores``), so that both packages sketch with
    the same operator.

    ``rank`` is the rank as a constructor takes it (for a right DRM, the
    reverse of the DRM's ``rank`` attribute); ``slice_kwargs`` may carry
    ``rank_min``/``rank_max``/``true_rank`` in the same orientation.  The
    DRM's dtype is the cores'."""
    from tt_sketch_torch.drm.tensor_train_drm import TensorTrainDRM

    cores = from_numpy_cores(cores, device)
    return TensorTrainDRM(rank, tuple(shape), transpose, seed=seed,
                          cores=cores, dtype=cores[0].dtype, **slice_kwargs)


def sparse_tensor_from_numpy(shape, indices, entries, device=None):
    """A ``SparseTensor`` on ``device`` from numpy (d, nnz) indices and
    (nnz,) entries."""
    from tt_sketch_torch.formats.sparse import SparseTensor

    return SparseTensor(shape, np.asarray(indices), np.asarray(entries),
                        device=resolve_device(device))


def _packed_u64(flat) -> Optional[np.ndarray]:
    """A flat index stream as int64 bit patterns: a (hi, lo) uint32 pair
    (the JAX plan's layout) is packed, a uint64/int64 array is viewed."""
    if flat is None:
        return None
    if isinstance(flat, (tuple, list)):
        hi, lo = (np.asarray(x).astype(np.uint64) for x in flat)
        flat = (hi << np.uint64(32)) | lo
    return np.asarray(flat).astype(np.uint64).view(np.int64)


def _plan_array(a, device) -> Optional[torch.Tensor]:
    return None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(device)


def mode_plan_from_numpy(perm, local_idx, slot_rows, n_chunks: int,
                         span: int, chunk: int, sorted_entries=None,
                         flat_left=None, flat_right=None, flat_left_om=None,
                         gather_slots=None, device=None):
    """The port's ``ModePlan`` from a JAX ``ModePlan``'s arrays (as numpy);
    the flat index streams may be (hi, lo) uint32 pairs."""
    from tt_sketch_torch.kernels.sparse_plan import ModePlan

    dev = functools.partial(_plan_array, device=resolve_device(device))
    return ModePlan(
        dev(np.asarray(perm)), dev(np.asarray(local_idx)),
        dev(np.asarray(slot_rows)), n_chunks, span, chunk,
        sorted_entries=dev(None if sorted_entries is None
                           else np.asarray(sorted_entries)),
        flat_left=dev(_packed_u64(flat_left)),
        flat_right=dev(_packed_u64(flat_right)),
        flat_left_om=dev(_packed_u64(flat_left_om)),
        gather_slots=dev(None if gather_slots is None
                         else np.asarray(gather_slots)),
    )


def window_plan_from_numpy(local_idx, chunk_window, chunk_first,
                           n_chunks: int, span: int, chunk: int,
                           n_windows: int, sorted_entries=None,
                           flat_left=None, flat_right=None, device=None):
    """The port's ``WindowPlan`` from a JAX ``WindowPlan``'s arrays (as
    numpy); the flat index streams may be (hi, lo) uint32 pairs."""
    from tt_sketch_torch.kernels.sparse_plan import WindowPlan

    dev = functools.partial(_plan_array, device=resolve_device(device))
    return WindowPlan(
        dev(np.asarray(local_idx)), dev(np.asarray(chunk_window)),
        dev(np.asarray(chunk_first)), n_chunks, span, chunk, n_windows,
        sorted_entries=dev(None if sorted_entries is None
                           else np.asarray(sorted_entries)),
        flat_left=dev(_packed_u64(flat_left)),
        flat_right=dev(_packed_u64(flat_right)),
    )


def cp_tensor_from_numpy(cores: Sequence[np.ndarray], device=None):
    """A ``CPTensor`` from numpy ``(n_i, rank)`` factors (e.g.
    ``np.asarray`` of a JAX ``CPTensor``'s ``cores``)."""
    from tt_sketch_torch.formats.cp import CPTensor

    return CPTensor(from_numpy_cores(cores, device))


def tucker_tensor_from_numpy(factors: Sequence[np.ndarray], core,
                             device=None):
    """A ``TuckerTensor`` from numpy ``(s_i, n_i)`` factors and its core."""
    from tt_sketch_torch.formats.tucker import TuckerTensor

    return TuckerTensor(from_numpy_cores(factors, device),
                        from_numpy_cores([core], device)[0])


def tensor_sum_from_numpy(summands, device=None):
    """A ``TensorSum`` whose summands are port tensors (kept as they are)
    or the numpy parts of one format, as a tuple: ``("tt", cores)``,
    ``("cp", cores)``, ``("tucker", factors, core)``, ``("sparse", shape,
    indices, entries)`` or ``("dense", array)``."""
    from tt_sketch_torch.formats.base import Tensor
    from tt_sketch_torch.formats.dense import DenseTensor
    from tt_sketch_torch.formats.tensor_sum import TensorSum
    from tt_sketch_torch.formats.tensor_train import TensorTrain

    def convert(s):
        if isinstance(s, Tensor):
            return s
        kind, *parts = s
        if kind == "tt":
            return TensorTrain(from_numpy_cores(parts[0], device))
        if kind == "cp":
            return cp_tensor_from_numpy(parts[0], device)
        if kind == "tucker":
            return tucker_tensor_from_numpy(*parts, device=device)
        if kind == "sparse":
            return sparse_tensor_from_numpy(*parts, device=device)
        if kind == "dense":
            return DenseTensor(from_numpy_cores(parts, device)[0])
        raise ValueError(f"unknown summand format {kind!r}")

    return TensorSum([convert(s) for s in summands])


def mpo_from_numpy(cores: Sequence[np.ndarray], device=None):
    """An ``MPO`` from numpy order-4 cores ``(r0, n_in, n_out, r1)`` (e.g.
    ``np.asarray`` of a JAX ``MPO``'s ``cores``)."""
    from tt_sketch_torch.solvers.tt_gmres import MPO

    return MPO(from_numpy_cores(cores, device))
