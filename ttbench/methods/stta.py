"""The sparse streaming sketch: ``stream_sketch(t, left_rank, right_rank,
seed=s, left_drm_type=..., right_drm_type=..., dtype=float32).to_tt()``
with hashed DRMs (``gaussian``: ``SparseGaussianDRM``, ``sign``:
``SparseSignDRM``)."""
from __future__ import annotations

import time

import torch

from ttbench.reference import sparse
from ttbench.work import counts


def drm_type(kind: str):
    from tt_sketch_torch.drm import SparseGaussianDRM, SparseSignDRM

    return {"gaussian": SparseGaussianDRM, "sign": SparseSignDRM}[kind]


def request(inputs, config, traffic, seed, clock):
    from tt_sketch_torch import stream_sketch

    t = inputs["program"]["tensor"]
    t0 = time.perf_counter()
    sk = stream_sketch(t, int(traffic["left_rank"]),
                       int(traffic["right_rank"]), seed=seed,
                       left_drm_type=drm_type(traffic["left_drm"]),
                       right_drm_type=drm_type(traffic["right_drm"]),
                       dtype=torch.float32, device=t.device)
    enqueue_s = time.perf_counter() - t0
    mid = clock.stage()
    tt = sk.to_tt()
    return {"sketch": (sk.Psi_cores, sk.Omega_mats), "tt": tt.cores,
            "enqueue_s": enqueue_s, "mid": mid}


def reference(inputs, config, traffic, seed, precision):
    raw = inputs["raw"]
    psis, omegas, cores = sparse.stta(
        raw["indices"], raw["entries"], raw["shape"],
        int(traffic["left_rank"]), int(traffic["right_rank"]), seed,
        traffic["left_drm"], traffic["right_drm"], precision)
    return {"sketch": (psis, omegas), "tt": cores}


def work(config, traffic):
    return counts.sparse_stta(*counts.coo(config), int(traffic["left_rank"]),
                              int(traffic["right_rank"]))
