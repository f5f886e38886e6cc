"""Host-side sort/chunk plans for the sparse Ψ segment reduction.

Counterpart of ``tt_sketch_tpu/kernels/sparse_plan.py`` (``ModePlan``,
``build_mode_plan``, ``WindowPlan``, ``build_window_plan``,
``build_psi_plan``, ``build_shard_psi_plans``).  Per mode μ the Ψ kernels compute

    Ψ_μ[i, j, m] = Σ_{k : idx_μ[k] = j}  left[i,k] · entries[k] · right[m,k].

A plan sorts the nnz stream by the mode index once on the host, cuts it into
equal chunks, and records per chunk the local row of every nnz (``span``
rows at most per chunk) and the global row of every slab slot.  The fused
kernels (``kernels/sparse_psi.py``) write one (span, r1, r2) slab per chunk
and ``_combine_slabs`` adds the slabs into Ψ.

A mode above ``window_threshold`` rows (FROSTT-lbnl's 868131-row mode) gets
a ``WindowPlan`` instead: its rows are cut into aligned windows of ``span``
rows, the sorted stream is padded per window to whole chunks, and
``psi_window_direct`` writes every window's finished Ψ rows in place, so
there is no slab stack and no combine.

The plans are built with numpy, in the JAX package's arithmetic, and their
arrays are then handed to the tensor's device as torch tensors.  The flat
hash inputs stay one int64 tensor each (the JAX package splits them into
uint32 hi/lo pairs because 64-bit integers are emulated on the TPU).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tt_sketch_torch.config import resolve_device
from tt_sketch_torch.rng.hash_rng import _flat_index_np

#: Modes at or below this size take the plain segment reduction.
DEFAULT_SORT_THRESHOLD = 512

#: Modes above this size get an aligned-window plan (``WindowPlan``).
DEFAULT_WINDOW_THRESHOLD = 65536

#: Rows per window and nnz per chunk of a ``WindowPlan`` (the JAX package's
#: defaults, kept so that plans agree).
DEFAULT_WINDOW_SPAN = 256
DEFAULT_WINDOW_CHUNK = 512

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

    def to(self, device) -> "ModePlan":
        """Copy with every array on ``device``."""
        arrays = ("perm", "local_idx", "slot_rows", "sorted_entries",
                  "flat_left", "flat_right", "flat_left_om", "gather_slots")
        return self._replace(**{
            name: getattr(self, name).to(device) for name in arrays
            if getattr(self, name) is not None})

    def __repr__(self) -> str:
        fused = "+fused" if self.sorted_entries is not None else ""
        gk = (f"+gatherK{self.gather_slots.shape[1]}"
              if self.gather_slots is not None else "")
        return (f"<ModePlan chunks={self.n_chunks} span={self.span} "
                f"chunk={self.chunk}{fused}{gk}>")


class WindowPlan:
    """Aligned-window direct-write grouping of one giant COO mode.

    The mode's rows are cut into ``n_windows`` aligned windows of ``span``
    rows (window w = rows [w·span, (w+1)·span)); the mode-sorted nnz stream
    is padded per window to a multiple of ``chunk`` slots and cut into
    chunks, so a window owns a run of adjacent chunks (one at least, also
    when it is empty).

    - ``local_idx`` (n_chunks·chunk,) int32: row minus window·span per
      padded sorted slot; the sentinel ``span`` marks a pad, which adds
      nothing.  Inside a window's run the rows are non-decreasing and the
      pads come last.
    - ``sorted_entries`` (n_chunks·chunk,): entries at the padded sorted
      order, zero at pads.
    - ``flat_left``/``flat_right`` (n_chunks·chunk,) int64 or None: flat
      prefix/suffix hash inputs at the padded sorted order (zero at pads);
      None at the boundary modes.
    - ``chunk_window`` (n_chunks,) int32: window id per chunk,
      non-decreasing.
    - ``chunk_first`` (n_chunks,) int32: 1 on a window's first chunk.

    The geometry ``n_chunks``, ``span``, ``chunk``, ``n_windows`` is plain
    ints; ``n_windows·span ≥ n_mu`` and callers slice the row padding off.
    There is no inclusive prefix (``flat_left_om`` is None): a window
    mode's Ω comes from ``omega_fused`` in nnz order.
    """

    flat_left_om = None
    gather_slots = None

    def __init__(self, local_idx, chunk_window, chunk_first, n_chunks: int,
                 span: int, chunk: int, n_windows: int, sorted_entries=None,
                 flat_left=None, flat_right=None) -> None:
        self.local_idx = local_idx
        self.chunk_window = chunk_window
        self.chunk_first = chunk_first
        self.n_chunks = int(n_chunks)
        self.span = int(span)
        self.chunk = int(chunk)
        self.n_windows = int(n_windows)
        self.sorted_entries = sorted_entries
        self.flat_left = flat_left
        self.flat_right = flat_right

    def _replace(self, **changes) -> "WindowPlan":
        fields = dict(
            local_idx=self.local_idx, chunk_window=self.chunk_window,
            chunk_first=self.chunk_first, n_chunks=self.n_chunks,
            span=self.span, chunk=self.chunk, n_windows=self.n_windows,
            sorted_entries=self.sorted_entries, flat_left=self.flat_left,
            flat_right=self.flat_right,
        )
        fields.update(changes)
        return WindowPlan(**fields)

    def transposed(self) -> "WindowPlan":
        """The same mode's plan seen from the reversed tensor."""
        return self._replace(flat_left=self.flat_right,
                             flat_right=self.flat_left)

    def map_entries(self, fn) -> "WindowPlan":
        """Copy with ``sorted_entries`` mapped through ``fn`` (which must
        keep the pads' zeros: a cast or a scaling)."""
        if self.sorted_entries is None:
            return self
        return self._replace(sorted_entries=fn(self.sorted_entries))

    def __repr__(self) -> str:
        return (f"<WindowPlan chunks={self.n_chunks} span={self.span} "
                f"chunk={self.chunk} windows={self.n_windows}>")


def _to_device(a, device):
    """A host plan array as a torch tensor on ``device`` (uint64 flat
    indices as their int64 bit patterns)."""
    if a is None:
        return None
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def build_window_plan(idx, n_mu: int, span: int = DEFAULT_WINDOW_SPAN,
                      chunk: Optional[int] = None, *, full_indices=None,
                      mu: Optional[int] = None,
                      shape: Optional[Sequence[int]] = None, entries=None,
                      device=None) -> WindowPlan:
    """The aligned-window plan of one giant mode from host indices: ``span``
    rows per window (rounded up to a multiple of 8), ``chunk`` slots per
    chunk (default 512); its arrays land on ``device``."""
    idx = np.asarray(idx)
    nnz = int(idx.shape[0])
    device = resolve_device(device)
    span = ((int(span) + 7) // 8) * 8
    C = int(chunk) if chunk is not None else DEFAULT_WINDOW_CHUNK

    perm = np.argsort(idx, kind="stable").astype(np.int32)
    sidx = idx[perm].astype(np.int64)
    n_windows = max(1, -(-int(n_mu) // span))
    win = sidx // span

    # every window gets at least one chunk; its nnz run is padded to a
    # multiple of C
    counts = np.bincount(win, minlength=n_windows)
    chunks_per = np.maximum(1, -(-counts // C))
    n_chunks = int(chunks_per.sum())
    N_pad = n_chunks * C

    # window w's run starts at slot chunk_base[w]·C of the padded stream
    chunk_base = np.concatenate([[0], np.cumsum(chunks_per)[:-1]])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_in_win = np.arange(nnz, dtype=np.int64) - starts[win]
    slot = chunk_base[win] * C + pos_in_win

    local = np.full(N_pad, span, np.int32)  # sentinel
    local[slot] = (sidx - win * span).astype(np.int32)
    chunk_window = np.repeat(np.arange(n_windows, dtype=np.int32),
                             chunks_per)
    first = np.zeros(n_chunks, np.int32)
    first[chunk_base] = 1

    sorted_entries = flat_left = flat_right = None
    if full_indices is not None and entries is not None:
        def _padded(flat_u64):
            out = np.zeros(N_pad, np.uint64)
            out[slot] = flat_u64
            return out

        full_indices = np.asarray(full_indices)
        shape = tuple(int(s) for s in shape)
        d = len(shape)
        sorted_entries = np.zeros(N_pad, np.asarray(entries).dtype)
        sorted_entries[slot] = np.asarray(entries)[perm]
        if mu > 0:
            flat_left = _padded(_flat_index_np(
                full_indices[:mu][:, perm], shape[:mu]))
        if mu < d - 1:
            flat_right = _padded(_flat_index_np(
                full_indices[::-1][: d - 1 - mu][:, perm],
                shape[::-1][: d - 1 - mu]))
    return WindowPlan(
        _to_device(local, device), _to_device(chunk_window, device),
        _to_device(first, device), n_chunks, span, C, n_windows,
        sorted_entries=_to_device(sorted_entries, device),
        flat_left=_to_device(flat_left, device),
        flat_right=_to_device(flat_right, device),
    )


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
                    force_span: Optional[int] = None,
                    force_gather_k: Optional[int] = None,
                    device=None) -> ModePlan:
    """The sort/chunk plan of one mode from host indices; its arrays land
    on ``device`` (default: the package default) as torch tensors.  With
    ``full_indices``/``mu``/``shape``/``entries`` the plan also carries
    the sorted streams of the fused kernels.

    ``force_span`` raises the span to a common value and ``force_gather_k``
    sets the gather width (0: no gather combine), so that the shards of
    ``build_shard_psi_plans`` share one geometry as the JAX package's
    do."""
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
    if force_span is not None:
        if force_span < span:
            raise ValueError(
                f"force_span={force_span} below computed span {span}")
        span = int(force_span)

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
    gk = force_gather_k if force_gather_k is not None else K
    gather_slots = None
    if K <= gk <= _GATHER_K_CAP:
        gather_slots = np.full((n_mu, gk), n_chunks * span, np.int32)
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
        return _to_device(a, device)

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
                   window_span: int = DEFAULT_WINDOW_SPAN,
                   device=None) -> Tuple[Optional[ModePlan], ...]:
    """Per-mode plan tuple of a COO tensor (None: the plain segment path).

    Pass host ``entries`` to get the fused kernels' sorted streams.  A mode
    above ``window_threshold`` rows (with ``entries``) gets a ``WindowPlan``
    of ``window_span`` rows per window instead of a ``ModePlan``."""
    indices = np.asarray(indices)

    def _plan(mu, n_mu):
        if int(n_mu) <= threshold:
            return None
        common = dict(chunk=chunk, full_indices=indices, mu=mu, shape=shape,
                      entries=entries, device=device)
        if int(n_mu) > window_threshold and entries is not None:
            return build_window_plan(indices[mu], int(n_mu),
                                     span=window_span, **common)
        return build_mode_plan(indices[mu], int(n_mu), **common)

    return tuple(_plan(mu, n_mu) for mu, n_mu in enumerate(shape))


def build_shard_psi_plans(indices, entries, shape: Sequence[int],
                          n_shards: int,
                          threshold: int = DEFAULT_SORT_THRESHOLD,
                          chunk: Optional[int] = None, device=None):
    """Per-nnz-shard plan tuples with one geometry per mode, for the
    sharded sketch (``tt_sketch_torch/dist/sharded.py``).

    The nnz stream is zero-padded (index 0…0, entry 0: exact, every Ψ/Ω
    term scales with its entry) to a multiple of ``n_shards`` and cut into
    equal contiguous shards.  Each shard gets its own sort/chunk plan
    (``ModePlan`` only: no window plans, as in the JAX package), with the
    chunk size of each mode picked from shard 0's statistics, the span of
    each mode the largest over the shards and one gather width (0, no
    gather combine, when any shard exceeds the cap).  The plans equal the
    JAX package's field by field; torch needs no common geometry to run
    them, but keeping it keeps the two packages' shards the same.

    Returns ``(idx_shards, ent_shards, plans)``: ``(n_shards, d, nnz_s)``
    and ``(n_shards, nnz_s)`` host arrays and a list over shards of
    per-mode plan tuples on ``device``."""
    indices = np.asarray(indices)
    entries = np.asarray(entries)
    d, nnz = indices.shape
    pad = -nnz % n_shards
    if pad:
        indices = np.concatenate(
            [indices, np.zeros((d, pad), indices.dtype)], axis=1)
        entries = np.concatenate([entries, np.zeros(pad, entries.dtype)])
    nnz_s = indices.shape[1] // n_shards
    idx_shards = indices.reshape(d, n_shards, nnz_s).transpose(1, 0, 2)
    ent_shards = entries.reshape(n_shards, nnz_s)

    plans = [[None] * len(shape) for _ in range(n_shards)]
    for mu, n_mu in enumerate(shape):
        if int(n_mu) <= threshold:
            continue
        boundary = mu == 0 or mu == len(shape) - 1
        C = (int(chunk) if chunk is not None
             else _pick_chunk(nnz_s, len(np.unique(idx_shards[0][mu])),
                              boundary=boundary))

        def _build(s, **force):
            return build_mode_plan(
                idx_shards[s][mu], int(n_mu), chunk=C,
                full_indices=idx_shards[s], mu=mu, shape=shape,
                entries=ent_shards[s], device=device, **force)

        built = [_build(s) for s in range(n_shards)]
        span = max(p.span for p in built)
        gk = (0 if any(p.gather_slots is None for p in built)
              else max(p.gather_slots.shape[1] for p in built))
        for s, p in enumerate(built):
            width = 0 if p.gather_slots is None else p.gather_slots.shape[1]
            uniform = p.span == span and width == gk
            plans[s][mu] = p if uniform else _build(
                s, force_span=span, force_gather_k=gk)
    return idx_shards, ent_shards, [tuple(p) for p in plans]
