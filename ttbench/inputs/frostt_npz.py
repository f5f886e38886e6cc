"""A COO file (``indices``, ``entries``, ``shape``) read raw and put on the
first card.  The program's tensor carries the sort/chunk plans that the
configuration's ``plan`` asks of ``build_psi_plan`` (``{}``: the library's
defaults), and the configuration's value and index types (``dtype``,
``index_dtype``, handed to ``SparseTensor.astype``)."""
from __future__ import annotations

import numpy as np
import torch


def make(config: dict, seed: int, devices, root) -> dict:
    from tt_sketch_torch.formats.sparse import SparseTensor
    from tt_sketch_torch.kernels.sparse_plan import build_psi_plan

    device = devices[0]
    with np.load(root / config["file"]) as data:
        indices = np.ascontiguousarray(data["indices"])
        entries = np.ascontiguousarray(data["entries"])
        shape = tuple(int(s) for s in data["shape"])
    if shape != tuple(config["shape"]) or entries.shape[0] != config["nnz"]:
        raise ValueError(f"{config['file']}: shape {shape} and "
                         f"{entries.shape[0]} nonzeros, the configuration "
                         f"states {tuple(config['shape'])} and "
                         f"{config['nnz']}")
    dtype = getattr(torch, config["dtype"])
    plan = build_psi_plan(indices, shape, entries=entries, device=device,
                          **config["plan"])
    tensor = SparseTensor(shape, indices, entries, psi_plan=plan,
                          device=device).astype(
        dtype, index_dtype=getattr(torch, config["index_dtype"]))
    raw = {"indices": torch.from_numpy(indices).to(device),
           "entries": torch.from_numpy(entries).to(device=device,
                                                   dtype=dtype),
           "shape": shape}
    return {"raw": raw, "program": {"tensor": tensor}}
