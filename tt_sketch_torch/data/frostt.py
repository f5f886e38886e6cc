"""FROSTT-scale sparse tensors from the committed synthetic stand-ins.

Counterpart of ``tt_sketch_tpu/data/frostt.py`` for what the sparse slice
needs: the registry of the three synthetic stand-ins (the exact shape of the
real FROSTT tensors, values from a ground-truth TT plus noise), a loader of
their committed ``.npz`` files, and ``sample_error``.  Downloading the real
tensors and synthesizing missing files come with a later slice: a missing
file raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from tt_sketch_torch.config import resolve_device
from tt_sketch_torch.formats.sparse import SparseTensor

DEFAULT_CACHE = Path("data")

#: generator version of the JAX package's synthetic ``.npz`` files
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
        FrosttInfo("uber-synthetic", "synthetic://uber", 3309490,
                   (183, 24, 1140, 1717)),
        FrosttInfo("nips-synthetic", "synthetic://nips", 3101609,
                   (2482, 2862, 14036, 17)),
        FrosttInfo("lbnl-synthetic", "synthetic-scatter://lbnl-network",
                   1698825, (1605, 4198, 1631, 4209, 868131)),
    ]
}


def load_frostt(name: str, cache_dir: Union[str, Path] = DEFAULT_CACHE,
                download: bool = True, psi_plan: bool = False,
                plan_kwargs: Optional[dict] = None,
                device=None) -> SparseTensor:
    """Load a synthetic FROSTT stand-in from ``<cache_dir>/<name>.npz``.

    The positional order is the JAX package's.  ``download`` is accepted
    for its signature: the port has no downloader, so a missing file
    raises ``FileNotFoundError`` either way, and with ``download=True`` the
    message says that nothing can be fetched.

    ``psi_plan=True`` attaches the sort/chunk plans (``build_psi_plan``
    with ``plan_kwargs``: ``threshold``, ``chunk``, ``window_threshold``,
    ``window_span``), built from the host arrays before the one copy to
    ``device`` (default: the package default); a mode above 65536 rows
    (lbnl's last) gets a ``WindowPlan``.  Entries stay float64
    as stored; ``astype`` casts them."""
    if name not in FROSTT_TENSORS:
        raise KeyError(f"unknown FROSTT tensor {name!r}; available: "
                       f"{sorted(FROSTT_TENSORS)}")
    path = Path(cache_dir) / f"{name}.npz"
    if not path.exists():
        raise FileNotFoundError(
            f"{path} not found: the port reads the committed synthetic "
            f"stand-ins and does not synthesize them yet"
            + ("; download=True cannot fetch it either, the port has no "
               "downloader" if download else ""))
    with np.load(path) as data:
        version = int(data["synth_version"]) if "synth_version" in data else 0
        if version != _SYNTH_VERSION:
            raise ValueError(
                f"{path} has synthetic generator version {version}, "
                f"expected {_SYNTH_VERSION}")
        shape = tuple(int(s) for s in data["shape"])
        indices, entries = data["indices"], data["entries"]
    device = resolve_device(device)
    plan = None
    if psi_plan:
        from tt_sketch_torch.kernels.sparse_plan import build_psi_plan

        plan = build_psi_plan(indices, shape, entries=entries, device=device,
                              **(plan_kwargs or {}))
    return SparseTensor(shape, indices, entries, psi_plan=plan, device=device)


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
