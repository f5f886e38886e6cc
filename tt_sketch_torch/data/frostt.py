"""FROSTT sparse tensors: the registry, the synthetic stand-ins, a ``.tns``
parser, the cached loader and ``sample_error``.

Counterpart of ``tt_sketch_tpu/data/frostt.py``.  The registry holds the
four real FROSTT tensors (their URLs kept as data) and three synthetic
stand-ins at the real shapes and nonzero counts; ``_grid_sizes`` and
``_synthesize`` are host numpy and give the JAX package's arrays bit for
bit.  The port has no downloader: a real tensor is read from a ``.npz`` or
``.tns.gz`` file placed in the cache directory, and nothing touches the
network.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from tt_sketch_torch.config import resolve_device
from tt_sketch_torch.formats.sparse import SparseTensor

DEFAULT_CACHE = Path("data")

#: generator version stamped into synthetic ``.npz`` caches; a cache of
#: another version is regenerated (the JAX package's ``_SYNTH_VERSION``)
_SYNTH_VERSION = 2


@dataclass(frozen=True)
class FrosttInfo:
    name: str
    url: str
    nnz: int
    shape: Tuple[int, ...]


FROSTT_TENSORS: Dict[str, FrosttInfo] = {
    info.name: info
    for info in [
        FrosttInfo(
            "nips",
            "https://s3.us-east-2.amazonaws.com/frostt/frostt_data/nips/nips.tns.gz",
            3101609, (2482, 2862, 14036, 17)),
        FrosttInfo(
            "uber",
            "https://s3.us-east-2.amazonaws.com/frostt/frostt_data/uber-pickups/uber.tns.gz",
            3309490, (183, 24, 1140, 1717)),
        FrosttInfo(
            "lbnl-network",
            "https://s3.us-east-2.amazonaws.com/frostt/frostt_data/lbnl-network/lbnl-network.tns.gz",
            1698825, (1605, 4198, 1631, 4209, 868131)),
        FrosttInfo(
            "matmul_5-5-5",
            "https://s3.us-east-2.amazonaws.com/frostt/frostt_data/matrix-multiplication/matmul_5-5-5.tns.gz",
            125, (25, 25, 25)),
        # synthetic stand-ins at the real shapes and nonzero counts: a
        # ground-truth TT on a Cartesian subgrid, plus noise
        FrosttInfo("uber-synthetic", "synthetic://uber", 3309490,
                   (183, 24, 1140, 1717)),
        FrosttInfo("nips-synthetic", "synthetic://nips", 3101609,
                   (2482, 2862, 14036, 17)),
        # scattered i.i.d. support (no low-rank structure) for the
        # 868131-row mode's window path
        FrosttInfo("lbnl-synthetic", "synthetic-scatter://lbnl-network",
                   1698825, (1605, 4198, 1631, 4209, 868131)),
    ]
}

_SYNTHETIC = ("synthetic://", "synthetic-scatter://")


def _grid_sizes(shape: Tuple[int, ...], nnz: int) -> Tuple[int, ...]:
    """Per-mode subset sizes whose product is about ``nnz``, each at most
    the mode size: the small modes are fixed first and the remaining budget
    is spread over the larger ones."""
    d = len(shape)
    sizes = [0] * d
    remaining = float(nnz)
    left = d
    for i in sorted(range(d), key=lambda i: shape[i]):
        s = max(1, min(shape[i], int(round(remaining ** (1.0 / left)))))
        sizes[i] = s
        remaining = max(1.0, remaining / s)
        left -= 1
    return tuple(sizes)


def _synthesize(info: FrosttInfo, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic host COO data ``(indices, entries)`` at a FROSTT scale.

    ``synthetic://``: the support is a Cartesian subgrid (a sorted random
    subset per mode, ``_grid_sizes``), the values a rank-12 TT with a
    decaying first core evaluated there, times ``1 + 0.1 * noise``.
    ``synthetic-scatter://``: i.i.d. indices and standard normal values.
    The subgrid values end in a ``np.tensordot``, whose last bit depends
    on the BLAS's thread count (the committed files: OpenBLAS, two
    threads)."""
    shape = info.shape
    d = len(shape)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, len(info.name), info.nnz]))
    if info.url.startswith("synthetic-scatter://"):
        idx = np.stack([rng.integers(0, n, info.nnz)
                        for n in shape]).astype(np.int64)
        return idx, rng.standard_normal(info.nnz)
    sizes = _grid_sizes(shape, info.nnz)
    subsets = [np.sort(rng.choice(n, size=s, replace=False))
               for n, s in zip(shape, sizes)]
    nnz = int(np.prod(sizes))
    mesh = np.meshgrid(*subsets, indexing="ij")
    idx = np.stack([m.reshape(-1) for m in mesh])

    rank = 12
    core_rng = np.random.default_rng(
        np.random.SeedSequence([seed + 7, info.nnz]))
    cores = [core_rng.standard_normal((1, shape[0], rank)) / np.sqrt(rank)]
    for n in shape[1:-1]:
        cores.append(core_rng.standard_normal((rank, n, rank))
                     / np.sqrt(rank))
    cores.append(core_rng.standard_normal((rank, shape[-1], 1)))
    cores[0] = cores[0] * np.exp(-np.arange(rank) / 2.0)[None, None, :]

    v = cores[0][0, subsets[0], :]
    for k in range(1, d):
        v = np.tensordot(v, cores[k][:, subsets[k], :], axes=([-1], [0]))
    vals = v.reshape(nnz)
    vals *= 1.0 + 0.1 * rng.standard_normal(nnz)
    return idx, vals


def _read_tns(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """Host ``(indices, entries)`` of a ``.tns``/``.tns.gz`` file: one
    nonzero a line, 1-based indices, then the value."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        mat = np.loadtxt(f, dtype=np.float64, ndmin=2)
    return mat[:, :-1].astype(np.int64).T - 1, mat[:, -1]


def parse_tns(path: Union[str, Path], shape: Optional[Tuple[int, ...]] = None,
              device=None) -> SparseTensor:
    """A FROSTT ``.tns``/``.tns.gz`` file as a ``SparseTensor`` on
    ``device`` (default: the package default); ``shape`` defaults to the
    largest index of each mode plus one."""
    path = Path(path)
    indices, entries = _read_tns(path)
    if entries.size == 0:
        raise ValueError(f"{path} contains no nonzeros")
    if shape is None:
        shape = tuple(int(m) + 1 for m in indices.max(axis=1))
    return SparseTensor(tuple(shape), indices, entries, device=device)


def load_frostt(name: str, cache_dir: Union[str, Path] = DEFAULT_CACHE,
                download: bool = True, psi_plan: bool = False,
                plan_kwargs: Optional[dict] = None,
                device=None) -> SparseTensor:
    """Load a FROSTT tensor by registry name, caching it as ``.npz``.

    Resolution: ``<cache>/<file>.npz`` (a synthetic one only at
    ``synth_version`` 2); else a synthetic stand-in is generated and cached;
    else ``<cache>/<file>.tns.gz`` is parsed and cached; else
    ``FileNotFoundError`` names the URL and the expected path.  The port has
    no downloader: with ``download=True`` the message says so.

    ``psi_plan=True`` attaches the sort/chunk plans (``build_psi_plan``
    with ``plan_kwargs``: ``threshold``, ``chunk``, ``window_threshold``,
    ``window_span``), built from the host arrays before the one copy to
    ``device`` (default: the package default); a mode above 65536 rows
    (lbnl's last) gets a ``WindowPlan``.  Entries stay float64; ``astype``
    casts them."""
    if name not in FROSTT_TENSORS:
        raise KeyError(f"unknown FROSTT tensor {name!r}; available: "
                       f"{sorted(FROSTT_TENSORS)}")
    info = FROSTT_TENSORS[name]
    cache = Path(cache_dir)
    synthetic = info.url.startswith(_SYNTHETIC)
    gz_path = cache / info.url.rsplit("/", 1)[-1]
    npz_path = (cache / f"{info.name}.npz" if synthetic
                else gz_path.with_suffix("").with_suffix(".npz"))

    def _mk(shape, indices, entries) -> SparseTensor:
        dev = resolve_device(device)
        plan = None
        if psi_plan:
            from tt_sketch_torch.kernels.sparse_plan import build_psi_plan

            plan = build_psi_plan(indices, shape, entries=entries,
                                  device=dev, **(plan_kwargs or {}))
        return SparseTensor(shape, indices, entries, psi_plan=plan,
                            device=dev)

    if npz_path.exists():
        with np.load(npz_path) as data:
            version = (int(data["synth_version"]) if "synth_version" in data
                       else 0)
            if not synthetic or version == _SYNTH_VERSION:
                return _mk(tuple(int(s) for s in data["shape"]),
                           data["indices"], data["entries"])
        npz_path.unlink()  # a stale synthetic cache: regenerated below
    if synthetic:
        indices, entries = _synthesize(info)
        cache.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(npz_path, indices=indices, entries=entries,
                            shape=np.asarray(info.shape),
                            synth_version=np.asarray(_SYNTH_VERSION))
        return _mk(info.shape, indices, entries)
    if not gz_path.exists():
        raise FileNotFoundError(
            f"FROSTT tensor {name!r} not cached: place {gz_path} (from "
            f"{info.url}) or {npz_path} in {cache}/"
            + ("; download=True cannot fetch it, the port has no "
               "downloader" if download else ""))
    indices, entries = _read_tns(gz_path)
    entries = np.ascontiguousarray(entries)
    cache.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(npz_path, indices=indices, entries=entries,
                        shape=np.asarray(info.shape))
    return _mk(info.shape, indices, entries)


def sample_error(tt, tensor: SparseTensor, n_samples: int = 10_000,
                 seed: int = 0) -> float:
    """Relative error of ``tt`` against ``n_samples`` of the tensor's
    nonzeros (the JAX package's draw for equal seeds)."""
    rng = np.random.default_rng(seed)
    sample = rng.choice(tensor.nnz, size=min(n_samples, tensor.nnz),
                        replace=False)
    sample = torch.from_numpy(sample).to(tensor.device)
    inds = tensor.indices[:, sample]
    entr = tensor.entries[sample]
    approx = tt.gather(inds).to(entr.dtype)
    return float(torch.linalg.norm(approx - entr) / torch.linalg.norm(entr))
