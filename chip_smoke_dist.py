"""The ranks of ``chip_smoke.py``'s phase 15: the sharded sketches.

``chip_smoke.phase_sharded`` starts ``run_rank`` in every rank of a world
with ``torch.multiprocessing`` (``spawn``: CUDA forbids ``fork`` after it
is initialized).  Each rank joins through ``initialize_multihost`` with
the backend it is given, loads the kernels that phase 1 built (the build
directory's cache), and drives the port's sharded entry points on its
card:

- uber at full size (3,309,696 nonzeros, float32, rank 10/20, a Gaussian
  pair, plans as ``load_frostt``'s defaults) on each mesh of
  ``UBER_MESHES``: once through ``sharded_sparse_stream_sketch`` at seed 0
  with every kernel's count set to 0 just before and read just after; then
  a ``make_sharded_sparse_sketcher`` prepared once and timed over fresh
  seeds (the world's time between barriers, this rank's time up to its
  ``all_reduce``, the ``all_reduce`` and its bytes); rank 0 also records
  the kernel calls of one sketch, holds each against its plain version and
  times and bounds them (``chip_smoke.path_figures``);
- the dense slab stream: ``sharded_dense_stream_sketch`` of the shared
  host ``X``, each rank's slab one ``dual_project`` launch;
- the paper's TT sum: ``sharded_tt_sum_stream_sketch`` of the shared
  stacked cores.

Each rank writes what it measured to ``<out>/rank<r>.json``; rank 0 writes
the sketches to ``<out>/sketches.npz``.  The parent holds them to the
single-device sketches.  Nothing here runs at import time, and nothing of
JAX is imported.
"""
import contextlib
import json
import os
import time

import numpy as np

#: the uber meshes: label -> (axis sizes, axis names); each covers the
#: world's four ranks
UBER_MESHES = {"data 4": ((4,), ("data",)),
               "data x left x right 1x2x2": ((1, 2, 2),
                                             ("data", "left", "right"))}
UBER_RANKS = (10, 20)
DENSE_RANKS = (32, 64)
TT_SUM_RANKS = (24, 25)
SEED = 0
#: fresh seeds of the prepared sketcher: the first is a warm-up
TIMED_SEEDS = tuple(range(100, 106))


@contextlib.contextmanager
def timed_reduce(rec):
    """Record ``(entry, exit, bytes)`` of every ``all_reduce`` the sharded
    sketches make, the device synchronized at both ends."""
    import torch

    from tt_sketch_torch.dist import sharded

    real = sharded._all_reduce_sum

    def wrapper(mesh, parts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(mesh, parts)
        torch.cuda.synchronize()
        rec.append((t0, time.perf_counter(),
                    sum(p.numel() * p.element_size() for p in parts)))
        return out

    sharded._all_reduce_sum = wrapper
    try:
        yield
    finally:
        sharded._all_reduce_sum = real


def _timed(run):
    """``run()`` between two world barriers: (result, world seconds, this
    rank's seconds up to its all_reduce, all_reduce seconds, bytes)."""
    import torch
    import torch.distributed as dist

    rec = []
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_reduce(rec):
        out = run()
    torch.cuda.synchronize()
    dist.barrier()
    world_s = time.perf_counter() - t0
    (entry, exit_, nbytes), = rec
    return out, world_s, entry - t0, exit_ - entry, nbytes


def _save(sketches, key, sk):
    for i, P in enumerate(sk.Psi_cores):
        sketches[f"{key}/psi{i}"] = P.cpu().numpy()
    for i, O in enumerate(sk.Omega_mats):
        sketches[f"{key}/omega{i}"] = O.cpu().numpy()


def _median_ms(rows, i):
    return float(np.median([r[i] for r in rows[1:]])) * 1e3


def uber_path(label, mesh, uber, ops, sketches):
    import torch
    import torch.distributed as dist

    import chip_smoke as C
    from tt_sketch_torch import SparseGaussianDRM
    from tt_sketch_torch.dist import (
        make_sharded_sparse_sketcher,
        sharded_sparse_stream_sketch,
    )
    from tt_sketch_torch.dist.sharded import _ranks, _seeds

    rank = dist.get_rank()
    axes = dict(left_rank_axis="left" if "left" in mesh.shape else None,
                right_rank_axis="right" if "right" in mesh.shape else None)
    t0 = time.perf_counter()
    sk, launches, _ = C._counted(lambda: sharded_sparse_stream_sketch(
        uber, *UBER_RANKS, seed=SEED, mesh=mesh, data_axis="data",
        dtype=torch.float32, **axes))
    entry_s = time.perf_counter() - t0
    if rank == 0:
        _save(sketches, f"uber {label}", sk)

    left, right = _ranks(*UBER_RANKS, uber.shape)
    t0 = time.perf_counter()
    sketch = make_sharded_sparse_sketcher(
        uber, left, right, mesh, "data", torch.float32, 512, None, **axes)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0

    def drms(seed):
        lseed, rseed = _seeds(seed, len(uber.shape))
        return (SparseGaussianDRM(left, uber.shape, False, seed=lseed,
                                  dtype=torch.float32),
                SparseGaussianDRM(right, uber.shape, True, seed=rseed,
                                  dtype=torch.float32))

    rows = []
    for seed in TIMED_SEEDS:
        pair = drms(seed)
        rows.append(_timed(lambda: sketch(*pair))[1:])
    out = {"launches": launches, "entry_s": entry_s, "prep_s": prep_s,
           "world_ms": _median_ms(rows, 0), "rank_ms": _median_ms(rows, 1),
           "all_reduce_ms": _median_ms(rows, 2), "all_reduce_bytes": rows[0][3],
           "world_ms_all": [r[0] * 1e3 for r in rows]}
    # one more sketch (a collective: every rank), its kernel calls
    # recorded; rank 0 holds its own against their plain versions, then
    # times and bounds them
    calls = {}
    pair = drms(TIMED_SEEDS[0])
    with C.recording(calls):
        sketch(*pair)
    if rank == 0:
        path = f"uber sharded {label} gauss"
        worst = {}
        for name in C.SPARSE_KERNELS:
            for i, args in enumerate(calls.get(name, [])):
                a, r = C._check(name, f"{path} rank 0 call {i}", args,
                                phase=15)
                w = worst.setdefault((name, path), [0.0, 0.0])
                w[0], w[1] = max(w[0], a), max(w[1], r)
        figures = C.path_figures({path: {"calls": calls, "shape": None}},
                                 worst, ops, phase=15)
        out["figures"] = {n: f[path] for n, f in figures.items() if f}
    dist.barrier()
    return out


def dense_path(mesh, X, sketches):
    import torch
    import torch.distributed as dist

    from tt_sketch_torch import profiling
    from tt_sketch_torch.dist import sharded_dense_stream_sketch

    runs = []
    for _ in range(2):
        profiling.reset_counters()
        sk, *times = _timed(lambda: sharded_dense_stream_sketch(
            X, *DENSE_RANKS, seed=SEED, mesh=mesh, dtype=torch.float32))
        runs.append(times)
    if dist.get_rank() == 0:
        _save(sketches, "dense", sk)
    del sk
    torch.cuda.empty_cache()
    return {"launches": {"dual_project": profiling.counters().get(
                "launches.dual_project", 0)},
            "world_ms": [r[0] * 1e3 for r in runs],
            "rank_ms": [r[1] * 1e3 for r in runs],
            "all_reduce_ms": [r[2] * 1e3 for r in runs],
            "all_reduce_bytes": runs[0][3]}


def tt_sum_path(mesh, stacked, shape, sketches):
    import torch
    import torch.distributed as dist

    from tt_sketch_torch.dist import sharded_tt_sum_stream_sketch

    runs = []
    for _ in range(2):
        sk, *times = _timed(lambda: sharded_tt_sum_stream_sketch(
            stacked, shape, *TT_SUM_RANKS, seed=SEED, mesh=mesh,
            dtype=torch.float64))
        runs.append(times)
    if dist.get_rank() == 0:
        _save(sketches, "tt_sum", sk)
    return {"world_ms": [r[0] * 1e3 for r in runs],
            "rank_ms": [r[1] * 1e3 for r in runs],
            "all_reduce_ms": [r[2] * 1e3 for r in runs],
            "all_reduce_bytes": runs[0][3]}


def run_rank(rank, cfg, X, stacked):
    """One rank of phase 15 (the target of ``torch.multiprocessing.spawn``;
    ``cfg``: world size, backend, port, output directory, the SASS counts
    of the bounds, the TT sum's shape)."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tt_sketch_torch.data.frostt import load_frostt
    from tt_sketch_torch.dist import initialize_multihost
    from tt_sketch_torch.dist.multihost import Mesh

    t_start = time.perf_counter()
    initialize_multihost(f"localhost:{cfg['port']}", cfg["world"], rank,
                         backend=cfg["backend"])
    world = dist.get_world_size()
    out = {"rank": rank, "backend": dist.get_backend(),
           "device": torch.cuda.current_device(),
           "card": torch.cuda.get_device_name()}
    sketches = {}
    # every rank passes the same host tensor; each uploads its own block
    uber = load_frostt("uber-synthetic", device="cpu").astype(torch.float32)
    meshes = {label: Mesh(np.arange(world).reshape(sizes), names)
              for label, (sizes, names) in UBER_MESHES.items()}
    out["join_s"] = time.perf_counter() - t_start
    for label, mesh in meshes.items():
        out[f"uber {label}"] = uber_path(label, mesh, uber, cfg["ops"],
                                         sketches)
    data = meshes["data 4"]
    out["dense"] = dense_path(data, X, sketches)
    out["tt_sum"] = tt_sum_path(data, stacked, cfg["tt_sum_shape"],
                                sketches)
    out["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if rank == 0:
        np.savez(os.path.join(cfg["out"], "sketches.npz"), **sketches)
    dist.barrier()
    dist.destroy_process_group()
