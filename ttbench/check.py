"""What decides ``correct``: the program's outputs against the plain
reference's, for a sample of the window's requests.

- ``sketch_rel``: the largest ``max|program - reference| / max|reference|``
  over the Psi cores and Omega matrices, the sketch that the kernels and
  the dispatch produced.
- ``tt_rel``: the recovered TT's values at sample points against the
  reference TT's there, ``|program - reference|_2 / |reference|_2``.  Values
  and not cores, since a QR's signs may flip cores.

Each number is the worst over the checked requests; each has a limit of
its own in the cell's traffic file.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List

import numpy as np
import torch


class Reservoir:
    """A uniform sample of ``k`` of the window's requests, drawn from the
    seed (reservoir sampling, so it needs no count of requests ahead)."""

    def __init__(self, k: int, seed: int) -> None:
        self.k = k
        self.rng = random.Random(seed)
        self.items: List[tuple] = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def tt_values(cores, idx: torch.Tensor) -> torch.Tensor:
    """float64 values of the TT at the (d, N) multi-indices."""
    out = cores[0][0, idx[0], :].to(torch.float64)
    for k in range(1, len(cores)):
        out = torch.einsum("nr,rns->ns", out,
                           cores[k][:, idx[k], :].to(torch.float64))
    return out.reshape(-1)


def sample_points(config: dict, raw: dict, n: int, seed: int,
                  device) -> torch.Tensor:
    """(d, n) points drawn from the seed: nonzeros of a sparse tensor,
    uniform over the grid of a dense one."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC4EC]))
    if "indices" in raw:
        nnz = raw["indices"].shape[1]
        pick = torch.from_numpy(rng.choice(nnz, size=min(n, nnz),
                                           replace=False)).to(device)
        return raw["indices"][:, pick]
    pts = np.stack([rng.integers(0, int(s), n) for s in config["shape"]])
    return torch.from_numpy(pts).to(device)


def _max_rel(got, ref) -> float:
    ref = ref.to(torch.float64)
    scale = float(ref.abs().max())
    diff = float((got.to(torch.float64) - ref).abs().max())
    return diff / scale if scale > 0 else math.inf


def compare(got: dict, ref: dict, points: torch.Tensor) -> Dict[str, float]:
    out = {}
    if ref["sketch"] is not None:
        g_parts = list(got["sketch"][0]) + list(got["sketch"][1])
        r_parts = list(ref["sketch"][0]) + list(ref["sketch"][1])
        out["sketch_rel"] = max(
            (_max_rel(g, r) if g.shape == r.shape else math.inf)
            for g, r in zip(g_parts, r_parts)) \
            if len(g_parts) == len(r_parts) else math.inf
    if [c.shape for c in got["tt"]] == [c.shape for c in ref["tt"]]:
        a, b = tt_values(got["tt"], points), tt_values(ref["tt"], points)
        norm = float(torch.linalg.norm(b))
        out["tt_rel"] = (float(torch.linalg.norm(a - b)) / norm if norm > 0
                         else math.inf)
    else:
        out["tt_rel"] = math.inf
    for k, v in out.items():
        if not math.isfinite(v):
            out[k] = math.inf
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    keys = readings[0].keys() if readings else ()
    return {k: max(r[k] for r in readings) for k in keys}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return bool(numbers) and all(
        k in numbers and numbers[k] <= lim for k, lim in limits.items())
