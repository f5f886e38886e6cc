"""Checkpoint / resume for sketch state.

Counterpart of ``tt_sketch_tpu/serialization.py``, with its ``.npz``
layout key for key: ``meta`` (a JSON header as uint8), ``Psi_i``,
``Omega_i`` and ``core_i``, format version 1.  A checkpoint written by
either package loads in the other.

The resumable state of a streaming sketch is ``(seed-derived DRMs,
SketchContainer)``: the container is a pure linear accumulator, and every
DRM regenerates exactly from its ``(class, rank, shape, transpose, seed,
dtype)`` metadata (TT-DRM cores from numpy's PCG64, hash DRMs from the
counter-based hash), so ``load_sketch`` returns a ``SketchedTensorTrain``
that continues streaming (``+ tensor``), grows rank or is assembled as if
it had never been checkpointed.  The metadata's ``dtype`` is the numpy name
(``"float32"``, ``"float64"``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from tt_sketch_torch.config import resolve_device
from tt_sketch_torch.engine.sketch import SketchedTensorTrain
from tt_sketch_torch.engine.sketch_container import SketchContainer
from tt_sketch_torch.formats.tensor_train import TensorTrain

_FORMAT_VERSION = 1

#: torch dtypes by the numpy names the metadata stores: those of the DRMs
#: and of numpy arrays that both packages write and read
_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def _drm_registry():
    import tt_sketch_torch.drm as drm_mod

    return {
        name: getattr(drm_mod, name)
        for name in (
            "DenseGaussianDRM",
            "SparseGaussianDRM",
            "SparseSignDRM",
            "TensorTrainDRM",
        )
    }


def _drm_meta(drm) -> dict:
    rank = drm.true_rank[::-1] if drm.transpose else drm.true_rank
    rank_min = drm.rank_min[::-1] if drm.transpose else drm.rank_min
    rank_max = drm.rank_max[::-1] if drm.transpose else drm.rank_max
    return {
        "cls": type(drm).__name__,
        "rank": list(rank),
        "rank_min": list(rank_min),
        "rank_max": list(rank_max),
        "shape": list(drm.shape),  # stored untransposed in the DRM
        "transpose": bool(drm.transpose),
        "seed": int(drm.seed),
        "dtype": _DTYPE_NAMES[drm.dtype],
        # SparseSignDRM extra state, saved raw and restored verbatim
        "nnz": list(getattr(drm, "nnz", [])) or None,
    }


def _drm_from_meta(meta: dict, device):
    cls = _drm_registry()[meta["cls"]]
    drm = cls(
        tuple(meta["rank"]),
        shape=tuple(meta["shape"]),
        transpose=meta["transpose"],
        seed=meta["seed"],
        rank_min=tuple(meta["rank_min"]),
        rank_max=tuple(meta["rank_max"]),
        true_rank=tuple(meta["rank"]),
        dtype=_DTYPES[meta["dtype"]],
        device=device,
    )
    if meta.get("nnz"):
        drm.nnz = tuple(meta["nnz"])
    return drm


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _read_meta(data, path, kind: str, what: str) -> dict:
    meta = json.loads(bytes(data["meta"]).decode())
    if meta.get("kind") != kind:
        raise ValueError(
            f"{path} is not a {what} checkpoint (kind={meta.get('kind')})"
        )
    return meta


def save_sketch(
    path: Union[str, Path],
    sketched: SketchedTensorTrain,
    extra: Optional[dict] = None,
) -> None:
    """Write a resumable checkpoint of a ``SketchedTensorTrain``.

    The write is atomic (tmp file + rename) so a crash mid-checkpoint never
    corrupts the previous one.  ``extra`` is a JSON-able dict stored in the
    metadata header (``StreamingSketchSession`` keeps its progress cursor
    there)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {
        "version": _FORMAT_VERSION,
        "kind": "sketched_tt",
        "shape": list(sketched.sketch_.shape),
        "left_drm": _drm_meta(sketched.left_drm),
        "right_drm": _drm_meta(sketched.right_drm),
    }
    if extra is not None:
        meta["extra"] = extra
    arrays = {"meta": _meta_array(meta)}
    for i, P in enumerate(sketched.sketch_.Psi_cores):
        arrays[f"Psi_{i}"] = _host(P)
    for i, O in enumerate(sketched.sketch_.Omega_mats):
        arrays[f"Omega_{i}"] = _host(O)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    tmp.replace(path)


def load_sketch(
    path: Union[str, Path], with_extra: bool = False, device=None
) -> SketchedTensorTrain:
    """Rebuild a ``SketchedTensorTrain`` on ``device`` (default: the
    package default) from a checkpoint; the DRMs are regenerated from their
    metadata there (exact, seed-deterministic).

    ``with_extra=True`` returns ``(sketched, extra_dict)``."""
    device = resolve_device(device)
    with np.load(Path(path)) as data:
        meta = _read_meta(data, path, "sketched_tt", "sketch")
        if meta["version"] > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint version {meta['version']} is newer than this "
                f"library supports ({_FORMAT_VERSION})"
            )
        d = len(meta["shape"])
        Psi = [torch.from_numpy(data[f"Psi_{i}"]).to(device)
               for i in range(d)]
        Omega = [torch.from_numpy(data[f"Omega_{i}"]).to(device)
                 for i in range(d - 1)]
    sketch = SketchContainer(Psi, Omega)
    left = _drm_from_meta(meta["left_drm"], device)
    right = _drm_from_meta(meta["right_drm"], device)
    sketched = SketchedTensorTrain(sketch, left, right)
    if with_extra:
        return sketched, meta.get("extra", {})
    return sketched


def save_tt(path: Union[str, Path], tt: TensorTrain) -> None:
    """Write a TensorTrain's cores to ``.npz``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {"version": _FORMAT_VERSION, "kind": "tensor_train"}
    arrays = {"meta": _meta_array(meta)}
    for i, C in enumerate(tt.cores):
        arrays[f"core_{i}"] = _host(C)
    np.savez(path, **arrays)


def load_tt(path: Union[str, Path], device=None) -> TensorTrain:
    """Read a TensorTrain written by ``save_tt`` onto ``device`` (default:
    the package default)."""
    device = resolve_device(device)
    with np.load(Path(path)) as data:
        _read_meta(data, path, "tensor_train", "TT")
        n = sum(1 for k in data.files if k.startswith("core_"))
        cores = [torch.from_numpy(data[f"core_{i}"]).to(device)
                 for i in range(n)]
    return TensorTrain(cores)
