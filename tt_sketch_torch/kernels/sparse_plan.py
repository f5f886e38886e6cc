"""Host-side sort/chunk plans for the sparse Ψ segment reduction.

Counterpart of ``tt_sketch_tpu/kernels/sparse_plan.py`` (``ModePlan``,
``build_mode_plan``, ``build_psi_plan``).  Per mode μ the Ψ kernels compute

    Ψ_μ[i, j, m] = Σ_{k : idx_μ[k] = j}  left[i,k] · entries[k] · right[m,k].

A plan sorts the nnz stream by the mode index once on the host, cuts it into
equal chunks, and records per chunk the local row of every nnz (``span``
rows at most per chunk) and the global row of every slab slot.  The fused
kernels (``kernels/sparse_psi.py``) write one (span, r1, r2) slab per chunk
and ``_combine_slabs`` adds the slabs into Ψ.

The plan is built with numpy, in the JAX package's arithmetic, and its
arrays are then handed to the tensor's device as torch tensors.  The flat
hash inputs stay one int64 tensor each (the JAX package splits them into
uint32 hi/lo pairs because 64-bit integers are emulated on the TPU).  Modes
above ``window_threshold`` would need the aligned-window plan and its
``psi_window_direct`` kernel, which the port does not have yet: they raise.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tt_sketch_torch.config import resolve_device
from tt_sketch_torch.rng.hash_rng import _flat_index_np

#: Modes at or below this size take the plain segment reduction.
DEFAULT_SORT_THRESHOLD = 512

#: Modes above this size need an aligned-window plan (not ported yet).
DEFAULT_WINDOW_THRESHOLD = 65536

#: Per-row gather multiplicity cap for the scatter-free combine.
_GATHER_K_CAP = 16


class ModePlan:
    """Sorted equal-chunk grouping of one COO mode.

    - ``perm`` (nnz,) int32: argsort of the mode's indices.
    - ``local_idx`` (n_chunks·chunk,) int32: sorted index minus its chunk's
      base row, padded with the sentinel ``span``.
    - ``slot_rows`` (n_chunks·span,) int32: global output row per slab slot
      (``n_mu`` for slots past the mode end: the combine drops them).
    - ``gather_slots`` ((n_mu, K) int32) or None: the scatter-free combine;
      row j sums the slots in its row (sentinel ``n_chunks·span`` = a zero
      slot).  None when a value spans more than ``_GATHER_K_CAP`` chunks.
    - ``sorted_entries`` (nnz,): ``entries[perm]``.
    - ``flat_left`` (nnz,) int64 or None: flat prefix index over modes
      ``0..μ-1`` in sorted order (left DRM rows of Ψ_μ); None for μ = 0.
    - ``flat_right``: flat suffix index over modes ``d-1..μ+1`` (the
      transposed tensor's prefix, hashed by the right DRM); None for
      μ = d-1.
    - ``flat_left_om``: flat prefix over ``0..μ`` (Ω_μ's left rows in the
      merged Ψ+Ω kernel); None for μ = d-1 and for transposed plans.

    The geometry ``n_chunks``, ``span``, ``chunk`` is plain ints.
    """

    def __init__(self, perm, local_idx, slot_rows, n_chunks: int, span: int,
                 chunk: int, sorted_entries=None, flat_left=None,
                 flat_right=None, flat_left_om=None,
                 gather_slots=None) -> None:
        self.perm = perm
        self.local_idx = local_idx
        self.slot_rows = slot_rows
        self.n_chunks = int(n_chunks)
        self.span = int(span)
        self.chunk = int(chunk)
        self.sorted_entries = sorted_entries
        self.flat_left = flat_left
        self.flat_right = flat_right
        self.flat_left_om = flat_left_om
        self.gather_slots = gather_slots

    def _replace(self, **changes) -> "ModePlan":
        fields = dict(
            perm=self.perm, local_idx=self.local_idx,
            slot_rows=self.slot_rows, n_chunks=self.n_chunks,
            span=self.span, chunk=self.chunk,
            sorted_entries=self.sorted_entries, flat_left=self.flat_left,
            flat_right=self.flat_right, flat_left_om=self.flat_left_om,
            gather_slots=self.gather_slots,
        )
        fields.update(changes)
        return ModePlan(**fields)

    def transposed(self) -> "ModePlan":
        """The same mode's plan seen from the reversed tensor: prefix and
        suffix swap, and the inclusive prefix is not available."""
        return self._replace(flat_left=self.flat_right,
                             flat_right=self.flat_left, flat_left_om=None)

    def map_entries(self, fn) -> "ModePlan":
        """Copy with ``sorted_entries`` mapped through ``fn``."""
        if self.sorted_entries is None:
            return self
        return self._replace(sorted_entries=fn(self.sorted_entries))

    def __repr__(self) -> str:
        fused = "+fused" if self.sorted_entries is not None else ""
        gk = (f"+gatherK{self.gather_slots.shape[1]}"
              if self.gather_slots is not None else "")
        return (f"<ModePlan chunks={self.n_chunks} span={self.span} "
                f"chunk={self.chunk}{fused}{gk}>")


def _pick_chunk(nnz: int, n_values: int, boundary: bool = False) -> int:
    """Chunk size from the mode's average occupancy per occurring value
    (the JAX package's rule, kept so that plans agree)."""
    avg = max(nnz / max(n_values, 1), 1.0)
    if avg >= 512:
        return 4096
    if avg >= 256:
        return 2048
    if avg >= 32:
        return 1024
    return 1024 if boundary else 256


def build_mode_plan(idx, n_mu: int, chunk: Optional[int] = None, *,
                    full_indices=None, mu: Optional[int] = None,
                    shape: Optional[Sequence[int]] = None, entries=None,
                    device=None) -> ModePlan:
    """The sort/chunk plan of one mode from host indices; its arrays land
    on ``device`` (default: the package default) as torch tensors.  With
    ``full_indices``/``mu``/``shape``/``entries`` the plan also carries
    the sorted streams of the fused kernels."""
    idx = np.asarray(idx)
    nnz = int(idx.shape[0])
    device = resolve_device(device)

    perm = np.argsort(idx, kind="stable").astype(np.int32)
    sidx = idx[perm].astype(np.int64)
    # compacted coordinates: rank among the values that occur
    uniq, ranks = np.unique(sidx, return_inverse=True)
    ranks = ranks.astype(np.int64)
    boundary = mu is not None and shape is not None and (
        mu == 0 or mu == len(shape) - 1
    )
    C = (int(chunk) if chunk is not None
         else _pick_chunk(nnz, len(uniq), boundary=boundary))

    n_chunks = max(1, -(-nnz // C))
    pad = n_chunks * C - nnz
    ranks_p = np.concatenate([ranks, np.full(pad, -1, np.int64)])
    tiles = ranks_p.reshape(n_chunks, C)
    base = tiles[:, 0]
    last = np.where(tiles[:, -1] >= 0, tiles[:, -1], tiles.max(axis=1))
    span = int((last - base).max()) + 1
    span = ((span + 7) // 8) * 8

    local = tiles - base[:, None]
    local[tiles < 0] = span  # padding sentinel
    local_idx = local.reshape(-1).astype(np.int32)

    slot_ranks = (
        base[:, None] + np.arange(span, dtype=np.int64)[None, :]
    ).reshape(-1)
    uniq_ext = np.concatenate([uniq, np.full(1, n_mu, np.int64)])
    slot_rows = uniq_ext[np.minimum(slot_ranks, uniq.shape[0])].astype(
        np.int32)

    n_vals = uniq.shape[0]
    starts = np.searchsorted(sidx, uniq, side="left")
    ends = np.searchsorted(sidx, uniq, side="right")
    c_first = starts // C
    c_last = (ends - 1) // C
    K = int((c_last - c_first + 1).max()) if n_vals else 1
    gather_slots = None
    if K <= _GATHER_K_CAP:
        gather_slots = np.full((n_mu, K), n_chunks * span, np.int32)
        vr = np.arange(n_vals, dtype=np.int64)
        for k in range(K):
            ck = c_first + k
            valid = ck <= c_last
            ckc = np.minimum(ck, n_chunks - 1)
            slot = ckc * span + (vr - base[ckc])
            gather_slots[uniq[valid], k] = slot[valid]

    sorted_entries = flat_left = flat_right = flat_left_om = None
    if full_indices is not None and entries is not None:
        full_indices = np.asarray(full_indices)
        shape = tuple(int(s) for s in shape)
        d = len(shape)
        sorted_entries = np.asarray(entries)[perm]
        if mu > 0:
            flat_left = _flat_index_np(full_indices[:mu][:, perm], shape[:mu])
        if mu < d - 1:
            flat_left_om = _flat_index_np(
                full_indices[: mu + 1][:, perm], shape[: mu + 1])
            flat_right = _flat_index_np(
                full_indices[::-1][: d - 1 - mu][:, perm],
                shape[::-1][: d - 1 - mu],
            )

    def _dev(a):
        if a is None:
            return None
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ModePlan(
        _dev(perm), _dev(local_idx), _dev(slot_rows), n_chunks, span, C,
        sorted_entries=_dev(sorted_entries), flat_left=_dev(flat_left),
        flat_right=_dev(flat_right), flat_left_om=_dev(flat_left_om),
        gather_slots=_dev(gather_slots),
    )


def build_psi_plan(indices, shape: Sequence[int],
                   threshold: int = DEFAULT_SORT_THRESHOLD,
                   chunk: Optional[int] = None, entries=None,
                   window_threshold: int = DEFAULT_WINDOW_THRESHOLD,
                   device=None) -> Tuple[Optional[ModePlan], ...]:
    """Per-mode plan tuple of a COO tensor (None: the plain segment path).

    Pass host ``entries`` to get the fused kernels' sorted streams.  A mode
    above ``window_threshold`` (with ``entries``) needs the aligned-window
    plan of ``psi_window_direct``, which the port does not have yet, and
    raises ``NotImplementedError``."""
    indices = np.asarray(indices)

    def _plan(mu, n_mu):
        if int(n_mu) <= threshold:
            return None
        if int(n_mu) > window_threshold and entries is not None:
            raise NotImplementedError(
                f"mode {mu} has {int(n_mu)} rows > window_threshold="
                f"{window_threshold}: it needs the aligned-window plan and "
                f"the psi_window_direct kernel, which the port does not "
                f"have yet"
            )
        return build_mode_plan(
            indices[mu], int(n_mu), chunk=chunk, full_indices=indices,
            mu=mu, shape=shape, entries=entries, device=device,
        )

    return tuple(_plan(mu, n_mu) for mu, n_mu in enumerate(shape))
