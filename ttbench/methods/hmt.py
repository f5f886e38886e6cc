"""The sequential one-sided sketch: ``hmt_sketch(t, rank, seed=s,
drm_type=..., dtype=float32)``, which returns the TT (a QR a mode, no
separate recovery)."""
from __future__ import annotations

import time

import torch

from ttbench.methods.stta import drm_type
from ttbench.reference import sparse
from ttbench.work import counts


def request(inputs, config, traffic, seed, clock):
    from tt_sketch_torch import hmt_sketch

    t = inputs["program"]["tensor"]
    t0 = time.perf_counter()
    tt = hmt_sketch(t, int(traffic["rank"]), seed=seed,
                    drm_type=drm_type(traffic["drm"]), dtype=torch.float32,
                    device=t.device)
    return {"sketch": None, "tt": tt.cores,
            "enqueue_s": time.perf_counter() - t0, "mid": None}


def reference(inputs, config, traffic, seed, precision):
    raw = inputs["raw"]
    cores = sparse.hmt(raw["indices"], raw["entries"], raw["shape"],
                       int(traffic["rank"]), seed, traffic["drm"], precision)
    return {"sketch": None, "tt": cores}


def work(config, traffic):
    return counts.sparse_hmt(*counts.coo(config), int(traffic["rank"]))
