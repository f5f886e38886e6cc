"""One rank of the gloo world that ``tests/test_torch_dist.py`` spawns.

Run as ``python tests/torch_dist_worker.py <out_dir>`` by every rank, with
``TT_SKETCH_TORCH_COORDINATOR``, ``TT_SKETCH_TORCH_NUM_PROCESSES`` and
``TT_SKETCH_TORCH_PROCESS_ID`` set.  Each rank joins the world through
``initialize_multihost`` (gloo: the package's default device is set to the
CPU), runs every case of ``CASES`` whose mesh holds it, and writes its
results to ``<out_dir>/rank<r>.npz``.  It imports ``tt_sketch_torch`` and
nothing of JAX; the inputs are made here and in the test from the same
numpy seeds (the functions below).
"""
import os
import sys

import numpy as np

SHAPE = (5, 6, 7, 4)
FUSED_SHAPE = (11, 9, 30, 25)
AXES = ("data", "left", "right")

#: every case: the kind, the mesh (sizes, axis names; its ranks are the
#: first ranks of the world in row-major order), the data axis and rank
#: axes it names, and its data and sketch arguments
CASES = {
    "sparse_8": dict(kind="sparse", mesh=((8,), ("data",)), nnz=77,
                     seed=0, sketch_seed=99),
    "sparse_222": dict(kind="sparse", mesh=((2, 2, 2), AXES), nnz=77,
                       seed=0, sketch_seed=99),
    "sparse_142": dict(kind="sparse", mesh=((1, 4, 2), AXES), nnz=77,
                       seed=0, sketch_seed=99),
    "pad_8": dict(kind="sparse", mesh=((8,), ("data",)), nnz=53, seed=3,
                  sketch_seed=5),
    "fused_4": dict(kind="fused", mesh=((4,), ("data",)), nnz=1000,
                    seed=12, sketch_seed=31),
    "fused_222": dict(kind="fused", mesh=((2, 2, 2), AXES), nnz=900,
                      seed=17, sketch_seed=41),
    "fused_142": dict(kind="fused", mesh=((1, 4, 2), AXES), nnz=900,
                      seed=17, sketch_seed=41),
    "fused_42": dict(kind="fused", mesh=((4, 2), ("data", "right")),
                     nnz=900, seed=17, sketch_seed=41),
    "tt_sum_8": dict(kind="tt_sum", mesh=((8,), ("data",)), n_sum=6,
                     tt_rank=2, seed=0, sketch_seed=7),
    "dense_8": dict(kind="dense", mesh=((8,), ("data",)), shape=(8, 5, 6, 4),
                    seed=0, sketch_seed=11),
    "dense_11": dict(kind="dense", mesh=((8,), ("data",)),
                     shape=(11, 5, 6, 4), seed=2, sketch_seed=11),
    "dense_exact": dict(kind="dense_tt", mesh=((8,), ("data",)),
                        shape=(8, 5, 6, 4), tt_rank=2, seed=3,
                        sketch_seed=5),
}
#: ranks of each kind (left, right)
RANKS = {"sparse": ((4, 4, 4), (8, 8, 8)), "fused": ((4, 4, 4), (8, 8, 8)),
         "tt_sum": ((5, 5, 5), (9, 9, 9)), "dense": (3, 6),
         "dense_tt": (2, 4)}
#: the fused planner's arguments (every mode planned at these shapes)
PLAN = dict(plan_threshold=8, plan_chunk=128)
#: the prepared sketcher's fresh seeds, on the mesh of ``fused_4``
SKETCHER_SEEDS = (31, 77)


def sparse_data(nnz, seed, dtype, shape=SHAPE):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape]).astype(np.int64)
    return idx, rng.standard_normal(nnz).astype(dtype)


def tt_cores(shape, rank, seed):
    rng = np.random.default_rng(seed)
    ranks = (1,) + (rank,) * (len(shape) - 1) + (1,)
    return [rng.standard_normal((ranks[i], n, ranks[i + 1]))
            for i, n in enumerate(shape)]


def tt_dense(cores):
    out = cores[0]
    for c in cores[1:]:
        out = np.tensordot(out, c, axes=1)
    return out[0, ..., 0]


def stacked_summands(n_sum, tt_rank, seed):
    """Cores of ``n_sum`` random TTs of ``SHAPE``, stacked per mode."""
    tts = [tt_cores(SHAPE, tt_rank, seed + i) for i in range(n_sum)]
    return [np.stack([t[mu] for t in tts]) for mu in range(len(SHAPE))]


def dense_input(case):
    if case["kind"] == "dense_tt":
        return tt_dense(tt_cores(case["shape"], case["tt_rank"],
                                 case["seed"]))
    return np.random.default_rng(case["seed"]).standard_normal(case["shape"])


def axes_of(case):
    """(data_axis, left_rank_axis, right_rank_axis) the case names."""
    names = case["mesh"][1]
    return tuple(a if a in names else None for a in AXES)


def _run(case, mesh):
    import torch

    from tt_sketch_torch.dist import (
        sharded_dense_stream_sketch,
        sharded_sparse_stream_sketch,
        sharded_tt_sum_stream_sketch,
    )
    from tt_sketch_torch.formats import SparseTensor

    kind = case["kind"]
    left, right = RANKS[kind]
    data_axis, left_axis, right_axis = axes_of(case)
    if kind in ("sparse", "fused"):
        f32 = kind == "fused"
        shape = FUSED_SHAPE if f32 else SHAPE
        idx, ent = sparse_data(case["nnz"], case["seed"],
                               np.float32 if f32 else np.float64, shape)
        return sharded_sparse_stream_sketch(
            SparseTensor(shape, idx, ent), left, right,
            seed=case["sketch_seed"], mesh=mesh, data_axis=data_axis,
            left_rank_axis=left_axis, right_rank_axis=right_axis,
            dtype=torch.float32 if f32 else torch.float64,
            **(PLAN if f32 else {}))
    if kind == "tt_sum":
        return sharded_tt_sum_stream_sketch(
            stacked_summands(case["n_sum"], case["tt_rank"], case["seed"]),
            SHAPE, left, right, seed=case["sketch_seed"], mesh=mesh)
    return sharded_dense_stream_sketch(
        dense_input(case), left, right, seed=case["sketch_seed"], mesh=mesh)


def _parts(sk):
    return ({f"psi{i}": P.numpy() for i, P in enumerate(sk.Psi_cores)}
            | {f"omega{i}": O.numpy() for i, O in enumerate(sk.Omega_mats)})


def main(out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from tt_sketch_torch import config

    config.set_default_device("cpu")
    from tt_sketch_torch.dist import global_mesh, initialize_multihost
    from tt_sketch_torch.dist import make_sharded_sparse_sketcher
    from tt_sketch_torch.dist.multihost import Mesh, P, make_global
    from tt_sketch_torch.drm import SparseGaussianDRM
    from tt_sketch_torch.formats import SparseTensor

    initialize_multihost()
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"backend": np.array(dist.get_backend())}
    # every rank builds every mesh, in one order (a sub-mesh's group is a
    # collective of the whole world)
    meshes = {name: Mesh(np.arange(int(np.prod(c["mesh"][0])))
                         .reshape(c["mesh"][0]), c["mesh"][1])
              for name, c in CASES.items()}
    for name, case in CASES.items():
        if rank in meshes[name]:
            for key, arr in _parts(_run(case, meshes[name])).items():
                out[f"{name}/{key}"] = arr

    # the prepared sketcher, called twice with fresh seeds
    mesh4 = meshes["fused_4"]
    if rank in mesh4:
        idx, ent = sparse_data(CASES["fused_4"]["nnz"],
                               CASES["fused_4"]["seed"], np.float32,
                               FUSED_SHAPE)
        left, right = RANKS["fused"]
        sketch = make_sharded_sparse_sketcher(
            SparseTensor(FUSED_SHAPE, idx, ent), left, right, mesh4, "data",
            torch.float32, PLAN["plan_threshold"], PLAN["plan_chunk"])
        for seed in SKETCHER_SEEDS:
            drms = (SparseGaussianDRM(left, FUSED_SHAPE, False, seed=seed,
                                      dtype=torch.float32),
                    SparseGaussianDRM(right, FUSED_SHAPE, True,
                                      seed=seed + 1, dtype=torch.float32))
            for key, arr in _parts(sketch(*drms)).items():
                out[f"sketcher@{seed}/{key}"] = arr

    # the mesh's layout and this rank's block of a known array
    grid = global_mesh(AXES, (2, 2, 2))
    out["coords"] = np.array([grid.coords()[a] for a in AXES])
    arr = np.arange(2 * 3 * 2).reshape(2 * 3, 2)
    out["block"] = make_global(grid, P("data"), arr).numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
