"""Sparse COO tensor format (counterpart of
``tt_sketch_tpu/formats/sparse.py``).

``indices`` is a ``(d, nnz)`` int64 tensor, ``entries`` an ``(nnz,)`` float
tensor, both on one device.  ``psi_plan`` optionally carries the per-mode
sort/chunk plans of ``kernels/sparse_plan.py`` (``ModePlan``, or
``WindowPlan`` for a giant mode) that the fused Ψ kernels run on.  ``split``
cuts the nonzeros into a ``TensorSum`` of shards, each with its own plans
if asked.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tt_sketch_torch.config import resolve_device
from tt_sketch_torch.formats.base import Tensor
from tt_sketch_torch.utils import random_normal


def _to_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.from_numpy(np.asarray(x)).to(resolve_device(device))


def _c_order_flat(indices: torch.Tensor, shape) -> torch.Tensor:
    """Row-major (C-order) flat index of (d, N) indices."""
    flat = torch.zeros(indices.shape[1], dtype=torch.int64,
                       device=indices.device)
    for i, n in enumerate(shape):
        flat = flat * int(n) + indices[i]
    return flat


class SparseTensor(Tensor):
    """COO tensor; numpy input moves to ``device`` (default: the package
    default), torch input stays where it lies unless ``device`` is given."""

    def __init__(self, shape: Tuple[int, ...], indices, entries,
                 psi_plan=None, device=None) -> None:
        if isinstance(indices, (tuple, list)):
            indices = np.stack([np.asarray(i) for i in indices])
        self.shape = tuple(int(s) for s in shape)
        self.indices = _to_device(indices, device).to(torch.int64)
        self.entries = _to_device(entries, device)
        if self.entries.device != self.indices.device:
            raise ValueError(
                f"indices lie on {self.indices.device}, entries on "
                f"{self.entries.device}"
            )
        #: per-mode ``ModePlan``, ``WindowPlan`` or None
        #: (kernels/sparse_plan.py)
        self.psi_plan = psi_plan

    @property
    def device(self) -> torch.device:
        return self.entries.device

    @property
    def dtype(self) -> torch.dtype:
        return self.entries.dtype

    def with_psi_plan(self, indices=None, threshold: int = 512,
                      entries=None, **plan_kwargs) -> SparseTensor:
        """Copy with sort/chunk Ψ plans attached, built on the host.

        ``indices``/``entries`` may pass host numpy arrays to skip the copy
        of the tensor's own arrays to the host.  ``plan_kwargs`` reach
        ``build_psi_plan`` (``chunk``, ``window_threshold``,
        ``window_span``)."""
        from tt_sketch_torch.kernels.sparse_plan import build_psi_plan

        host_indices = (self.indices.cpu().numpy() if indices is None
                        else np.asarray(indices))
        host_entries = (self.entries.cpu().numpy() if entries is None
                        else np.asarray(entries))
        plan = build_psi_plan(
            host_indices, self.shape, threshold=threshold,
            entries=host_entries, device=self.device, **plan_kwargs
        )
        return SparseTensor(self.shape, self.indices, self.entries, plan)

    def _map_plan_entries(self, fn):
        if self.psi_plan is None:
            return None
        return tuple(
            None if p is None else p.map_entries(fn) for p in self.psi_plan
        )

    @property
    def T(self) -> SparseTensor:
        plan = None if self.psi_plan is None else tuple(
            None if p is None else p.transposed()
            for p in self.psi_plan[::-1]
        )
        return SparseTensor(
            self.shape[::-1], self.indices.flip(0), self.entries, plan
        )

    @property
    def nnz(self) -> int:
        return int(self.entries.shape[0])

    def astype(self, dtype, index_dtype=None) -> SparseTensor:
        """Copy with ``entries`` (and the plans' sorted entries) cast to
        ``dtype``.  ``index_dtype`` is accepted for the JAX package's
        signature, where it casts the indices (int32 for the TPU's lanes);
        here it does nothing and the indices stay int64, the type every
        kernel of the port reads."""
        return SparseTensor(
            self.shape, self.indices, self.entries.to(dtype),
            self._map_plan_entries(lambda e: e.to(dtype)),
        )

    @property
    def size(self) -> int:
        return self.nnz * (self.ndim + 1)

    def split(self, n_summands: int, psi_plan: bool = False,
              **plan_kwargs):
        """Split nnz into ``n_summands`` contiguous shards (a ``TensorSum``);
        the last shard takes the remainder.

        ``psi_plan=True`` attaches sort/chunk plans to every shard
        (``with_psi_plan``, ``plan_kwargs`` forwarded), built on the host
        from one host copy of the tensor, so that each summand takes the
        fused kernels."""
        from tt_sketch_torch.formats.tensor_sum import TensorSum

        if psi_plan:
            host_indices = self.indices.cpu().numpy()
            host_entries = self.entries.cpu().numpy()
        block = self.nnz // n_summands
        parts = []
        for i in range(n_summands):
            sl = slice(i * block,
                       (i + 1) * block if i < n_summands - 1 else self.nnz)
            part = SparseTensor(self.shape, self.indices[:, sl],
                                self.entries[sl])
            if psi_plan:
                part = part.with_psi_plan(indices=host_indices[:, sl],
                                          entries=host_entries[sl],
                                          **plan_kwargs)
            parts.append(part)
        return TensorSum(parts)

    def to_dense(self) -> torch.Tensor:
        X = torch.zeros(self.shape, dtype=self.entries.dtype,
                        device=self.device)
        return X.index_put_(tuple(self.indices), self.entries,
                            accumulate=True)

    def norm(self) -> float:
        return float(torch.linalg.norm(self.entries))

    def dot(self, other, reverse: bool = False) -> float:
        if hasattr(other, "gather"):
            other_entries = other.gather(self.indices)
            return float(torch.dot(other_entries, self.entries))
        return super().dot(other, reverse=reverse)

    def gather(self, indices) -> torch.Tensor:
        """Entries at the queried (d, N) multi-indices (0 where absent):
        sorted flat indices and ``searchsorted``."""
        indices = _to_device(indices, self.device).to(torch.int64)
        my_flat = _c_order_flat(self.indices, self.shape)
        q_flat = _c_order_flat(indices, self.shape)
        sorted_flat, order = torch.sort(my_flat)
        sorted_entries = self.entries[order]
        pos = torch.searchsorted(sorted_flat, q_flat)
        pos = pos.clamp(0, sorted_flat.shape[0] - 1)
        hit = sorted_flat[pos] == q_flat
        return torch.where(hit, sorted_entries[pos],
                           torch.zeros((), dtype=self.entries.dtype,
                                       device=self.device))

    def __mul__(self, other: float) -> SparseTensor:
        return SparseTensor(
            self.shape, self.indices, self.entries * other,
            self._map_plan_entries(lambda e: e * other),
        )

    def __repr__(self) -> str:
        return (
            f"<Sparse tensor of shape {self.shape} with {self.nnz} "
            f"non-zero entries>"
        )

    @classmethod
    def random(cls, shape: Tuple[int, ...], nnz: int,
               seed: Optional[int] = None, dtype=None,
               device=None) -> SparseTensor:
        """``nnz`` distinct random positions with Gaussian values (the JAX
        package's draws for equal seeds)."""
        rng = np.random.default_rng(np.random.SeedSequence(seed))
        total = int(np.prod(shape))
        flat = rng.choice(total, size=nnz, replace=False)
        indices = np.stack(np.unravel_index(flat, shape))
        entries = random_normal((nnz,), seed=seed, dtype=dtype, device=device)
        return cls(shape, indices, entries, device=entries.device)
