"""The port's sharded sketches (``tt_sketch_torch.dist``) against the JAX
package's, on the CPU over gloo.

One 8-rank gloo world (``tests/torch_dist_worker.py``, one process per
rank) runs every case once for the whole file; each case is compared two
ways: with the JAX package's sharded sketch on the 8-device virtual CPU
mesh of ``tests/conftest.py`` at the same arguments, and with the port's
own single-device sketch.  The fused float32 cases run the JAX package's
Pallas kernels in interpret mode (``TT_SKETCH_TPU_FORCE_TPU=1``,
``TT_SKETCH_TPU_PALLAS_INTERPRET=1``), as ``tests/test_dist.py`` does.
Tolerances, with their reasons:

- float64 sketches: ``atol`` 1e-10 (the same products summed in another
  order; ``tests/test_dist.py``'s bound);
- float32 fused sketches: ``3e-5·max|ref|`` (float32 sums in another
  order, the bound of ``tests/test_dist.py:166``);
- exact recovery: relative error below 1e-9;
- plans and salts: exact.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_dist_worker as W
from tt_sketch_torch import config
from tt_sketch_torch.dist import sharded as S
from tt_sketch_torch.drm import SparseGaussianDRM, TensorTrainDRM
from tt_sketch_torch.engine.sketch import assemble_sketched_tt, stream_sketch
from tt_sketch_torch.engine.sketch_container import SketchContainer
from tt_sketch_torch.formats import DenseTensor, SparseTensor, TensorSum
from tt_sketch_torch.formats import TensorTrain
from tt_sketch_torch.kernels.sparse_plan import build_shard_psi_plans
from tt_sketch_tpu import dist as jdist
from tt_sketch_tpu.dist.sharded import _block_salts as j_block_salts
from tt_sketch_tpu.formats import SparseTensor as JST
from tt_sketch_tpu.kernels.sparse_plan import (
    build_shard_psi_plans as j_build_shard_psi_plans,
)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
F64_ATOL = 1e-10
F32_REL = 3e-5


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("TT_SKETCH_TPU_FORCE_TPU", "1")
    monkeypatch.setenv("TT_SKETCH_TPU_PALLAS_INTERPRET", "1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(n, args, env_extra=None, timeout=240):
    """Run ``python <args>`` as ``n`` ranks joined by the
    ``TT_SKETCH_TORCH_*`` variables; kill the rest when one fails."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        env.update(
            PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
            OMP_NUM_THREADS="1",
            TT_SKETCH_TORCH_COORDINATOR=f"127.0.0.1:{port}",
            TT_SKETCH_TORCH_NUM_PROCESSES=str(n),
            TT_SKETCH_TORCH_PROCESS_ID=str(rank), **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, *args], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out.decode(errors="replace"))
            if p.returncode != 0:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(i, p.returncode) for i, p in enumerate(procs)
              if p.returncode != 0]
    assert not failed, f"ranks failed {failed}:\n" + "\n".join(logs)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results, from one 8-rank gloo world."""
    out = tmp_path_factory.mktemp("torch_dist")
    spawn_world(WORLD, [str(ROOT / "tests" / "torch_dist_worker.py"),
                        str(out)])
    results = []
    for rank in range(WORLD):
        with np.load(out / f"rank{rank}.npz") as f:
            results.append(dict(f))
    return results


def _sketch_parts(world, name, rank=0):
    parts = world[rank]
    psi = [parts[f"{name}/psi{i}"] for i in range(4)]
    om = [parts[f"{name}/omega{i}"] for i in range(3)]
    return psi + om


def _close(ours, ref, f32):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        atol = F32_REL * np.abs(b).max() if f32 else F64_ATOL
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _parts(sk):
    return [np.asarray(t) for t in list(sk.Psi_cores) + list(sk.Omega_mats)]


# -- the JAX package's sharded sketches at the same arguments ------------------

def _jax_mesh(case):
    sizes, names = case["mesh"]
    devices = np.array(jax.devices()[: int(np.prod(sizes))]).reshape(sizes)
    return JMesh(devices, names)


def _jax_sharded(case):
    kind = case["kind"]
    left, right = W.RANKS[kind]
    mesh = _jax_mesh(case)
    data_axis, left_axis, right_axis = W.axes_of(case)
    if kind in ("sparse", "fused"):
        f32 = kind == "fused"
        shape = W.FUSED_SHAPE if f32 else W.SHAPE
        idx, ent = W.sparse_data(case["nnz"], case["seed"],
                                 np.float32 if f32 else np.float64, shape)
        return jdist.sharded_sparse_stream_sketch(
            JST(shape, idx, ent), left, right, seed=case["sketch_seed"],
            mesh=mesh, data_axis=data_axis, left_rank_axis=left_axis,
            right_rank_axis=right_axis,
            dtype=jnp.float32 if f32 else jnp.float64,
            **(W.PLAN if f32 else {}))
    if kind == "tt_sum":
        return jdist.sharded_tt_sum_stream_sketch(
            [jnp.asarray(c) for c in W.stacked_summands(
                case["n_sum"], case["tt_rank"], case["seed"])],
            W.SHAPE, left, right, seed=case["sketch_seed"], mesh=mesh)
    return jdist.sharded_dense_stream_sketch(
        jnp.asarray(W.dense_input(case)), left, right,
        seed=case["sketch_seed"], mesh=mesh)


# -- the port's single-device sketches -----------------------------------------

def _single_device(case):
    kind = case["kind"]
    left, right = W.RANKS[kind]
    seed = case["sketch_seed"]
    if kind in ("sparse", "fused"):
        f32 = kind == "fused"
        shape = W.FUSED_SHAPE if f32 else W.SHAPE
        idx, ent = W.sparse_data(case["nnz"], case["seed"],
                                 np.float32 if f32 else np.float64, shape)
        t = SparseTensor(shape, idx, ent)
        if f32:
            t = t.with_psi_plan(threshold=8, chunk=128)
        return stream_sketch(
            t, left, right, seed=seed, left_drm_type=SparseGaussianDRM,
            right_drm_type=SparseGaussianDRM,
            dtype=torch.float32 if f32 else torch.float64)
    if kind == "tt_sum":
        stacked = W.stacked_summands(case["n_sum"], case["tt_rank"],
                                     case["seed"])
        tts = [TensorTrain([torch.from_numpy(c[k]) for c in stacked])
               for k in range(case["n_sum"])]
        return stream_sketch(TensorSum(tts), left, right, seed=seed,
                             left_drm_type=TensorTrainDRM,
                             right_drm_type=TensorTrainDRM)
    return stream_sketch(DenseTensor(torch.from_numpy(W.dense_input(case))),
                         left, right, seed=seed)


def _interpret_if_fused(case, request):
    if case["kind"] == "fused":
        request.getfixturevalue("pallas_interpret")


@pytest.mark.parametrize("name", list(W.CASES))
def test_sharded_matches_jax_sharded(world, name, request):
    case = W.CASES[name]
    _interpret_if_fused(case, request)
    ref = _jax_sharded(case)
    _close(_sketch_parts(world, name), _parts(ref), case["kind"] == "fused")


@pytest.mark.parametrize("name", list(W.CASES))
def test_sharded_matches_single_device(world, name):
    case = W.CASES[name]
    single = _single_device(case)
    _close(_sketch_parts(world, name), _parts(single),
           case["kind"] == "fused")


def test_every_rank_gets_the_whole_sketch(world):
    """The SPMD form: each rank of a case's mesh returns the same whole
    sketch (one all_reduce, ``out_specs=P()`` in the JAX package)."""
    for name, case in W.CASES.items():
        n = int(np.prod(case["mesh"][0]))
        first = _sketch_parts(world, name)
        for rank in range(1, n):
            for a, b in zip(_sketch_parts(world, name, rank), first):
                np.testing.assert_array_equal(a, b, f"{name} rank {rank}")
        for rank in range(n, WORLD):
            assert f"{name}/psi0" not in world[rank]


def test_dense_exact_recovery(world):
    case = W.CASES["dense_exact"]
    cores = [torch.from_numpy(c) for c in
             W.tt_cores(case["shape"], case["tt_rank"], case["seed"])]
    parts = [torch.from_numpy(a) for a in _sketch_parts(world,
                                                        "dense_exact")]
    rec = TensorTrain(assemble_sketched_tt(SketchContainer(parts[:4],
                                                           parts[4:])))
    assert rec.error(TensorTrain(cores), relative=True) < 1e-9


@pytest.mark.parametrize("seed", W.SKETCHER_SEEDS)
def test_prepared_sketcher_takes_fresh_seeds(world, seed):
    """``make_sharded_sparse_sketcher`` plans and uploads once; each call
    with fresh DRMs equals the single-device fused sketch with them."""
    case = W.CASES["fused_4"]
    idx, ent = W.sparse_data(case["nnz"], case["seed"], np.float32,
                             W.FUSED_SHAPE)
    left, right = W.RANKS["fused"]
    drms = (SparseGaussianDRM(left, W.FUSED_SHAPE, False, seed=seed,
                              dtype=torch.float32),
            SparseGaussianDRM(right, W.FUSED_SHAPE, True, seed=seed + 1,
                              dtype=torch.float32))
    t = SparseTensor(W.FUSED_SHAPE, idx, ent).with_psi_plan(threshold=8,
                                                            chunk=128)
    single = stream_sketch(t, left, right, left_drm=drms[0],
                           right_drm=drms[1])
    _close(_sketch_parts(world, f"sketcher@{seed}"), _parts(single), True)


def test_global_mesh_is_row_major_and_make_global_gives_the_block(world):
    """The mesh lays ranks out row-major over its axes, as
    ``np.array(jax.devices()).reshape(sizes)``; ``make_global`` returns
    only this rank's block (JAX returns the global array)."""
    arr = np.arange(2 * 3 * 2).reshape(2 * 3, 2)
    for rank, res in enumerate(world):
        coords = np.unravel_index(rank, (2, 2, 2))
        assert res["coords"].tolist() == list(coords)
        np.testing.assert_array_equal(
            res["block"], arr[3 * coords[0]: 3 * coords[0] + 3])
        assert str(res["backend"]) == "gloo"


# -- plans, salts and helpers (no world) -----------------------------------------

@pytest.mark.parametrize("n_shards,nnz,chunk", [
    (4, 1000, 128), (8, 53, None), (3, 900, None), (2, 2000, 64)])
def test_shard_plans_match_jax(n_shards, nnz, chunk):
    """Every shard's plans equal the JAX package's field by field (flat
    streams as one int64 stream against its uint32 pair)."""
    idx, ent = W.sparse_data(nnz, 5, np.float32, W.FUSED_SHAPE)
    ours = build_shard_psi_plans(idx, ent, W.FUSED_SHAPE, n_shards,
                                 threshold=8, chunk=chunk, device="cpu")
    ref = j_build_shard_psi_plans(idx, ent, W.FUSED_SHAPE, n_shards,
                                  threshold=8, chunk=chunk)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    for s in range(n_shards):
        for p, q in zip(ours[2][s], ref[2][s]):
            assert (p is None) == (q is None)
            if p is None:
                continue
            assert ((p.n_chunks, p.span, p.chunk)
                    == (q.n_chunks, q.span, q.chunk))
            for name in ("perm", "local_idx", "slot_rows", "sorted_entries",
                         "gather_slots"):
                a, b = getattr(p, name), getattr(q, name)
                assert (a is None) == (b is None), name
                if a is not None:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            for name in ("flat_left", "flat_right", "flat_left_om"):
                a, b = getattr(p, name), getattr(q, name)
                assert (a is None) == (b is None), name
                if a is not None:
                    hi, lo = (np.asarray(x).astype(np.uint64) for x in b)
                    np.testing.assert_array_equal(
                        a.numpy().view(np.uint64), (hi << np.uint64(32)) | lo)


@pytest.mark.parametrize("off,blk", [(0, 4), (4, 4), (8, 8), (3, 5),
                                     (60, 16)])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 123, 2 ** 32 - 2])
def test_sliced_drm_salts_are_block_salts(off, blk, seed):
    """A DRM sliced to columns ``[off_μ, off_μ + blk)`` of bond μ hashes
    with the JAX package's rank-block salts, bit for bit: the left DRM at
    generator step μ, the right DRM at step d-2-μ."""
    shape = (5, 6, 7, 4, 3)
    d = len(shape)
    offs = tuple(off + k for k in range(d - 1))
    lo, hi = offs, tuple(o + blk for o in offs)
    left = SparseGaussianDRM(80, shape, False, seed=seed).slice(lo, hi)
    right = SparseGaussianDRM(80, shape, True, seed=seed).slice(lo, hi)
    for mu in range(d - 1):
        for drm, step in ((left, mu), (right, d - 2 - mu)):
            ours = S._block_salts(seed, step, offs[mu], blk)
            ref = np.asarray(j_block_salts(seed, step,
                                           jnp.uint64(offs[mu]), blk))
            np.testing.assert_array_equal(ours.numpy().view(np.uint64), ref)
            assert torch.equal(drm.salts(step), ours)


def test_helpers():
    assert S._block_sizes((4, 8), 2) == (2, 4)
    with pytest.raises(ValueError, match="divisible"):
        S._block_sizes((4, 6), 4)
    idx = torch.arange(6).reshape(2, 3)
    ent = torch.tensor([1.0, 2.0, 3.0])
    pi, pe = S._pad_nnz(idx, ent, 4)
    assert pi.tolist() == [[0, 1, 2, 0], [3, 4, 5, 0]]
    assert pe.tolist() == [1.0, 2.0, 3.0, 0.0]
    assert S._pad_nnz(idx, ent, 3)[1] is ent


def test_one_rank_without_a_process_group():
    """A single process sketches alone on a mesh of one rank (no process
    group), equal to ``stream_sketch`` with the same DRMs."""
    from tt_sketch_torch.dist import global_mesh, sharded_dense_stream_sketch

    X = np.random.default_rng(4).standard_normal((6, 5, 4))
    sk = sharded_dense_stream_sketch(X, 2, 3, seed=3, mesh=global_mesh())
    ref = stream_sketch(DenseTensor(torch.from_numpy(X)), 2, 3,
                        left_drm=sk.left_drm, right_drm=sk.right_drm)
    _close(_parts(sk), _parts(ref), False)


def test_unused_mesh_axis_and_indivisible_block_raise():
    from tt_sketch_torch.dist import global_mesh, make_global
    from tt_sketch_torch.dist.multihost import P

    mesh = global_mesh(("data", "left"), (1, 1))
    assert S._mesh_axes(mesh, "data", None) == ("data",)
    with pytest.raises(ValueError, match="not an axis"):
        S._mesh_axes(mesh, "right")
    block = make_global(mesh, P(None, "data"), np.arange(6).reshape(2, 3))
    assert block.tolist() == [[0, 1, 2], [3, 4, 5]]


# -- the multi-process counterpart of tests/test_multihost.py -----------------

_WORKER = r"""
import os, sys
import numpy as np
import torch
from tt_sketch_torch import config
config.set_default_device("cpu")
from tt_sketch_torch.dist import initialize_multihost, global_mesh
from tt_sketch_torch.dist import sharded_sparse_stream_sketch
from tt_sketch_torch.dist.multihost import process_count, process_index
from tt_sketch_torch.formats import SparseTensor

initialize_multihost()
assert process_count() == 2, process_count()
mesh = global_mesh(("data",))
shape = (6, 5, 4, 6)
rng = np.random.default_rng(0)
nnz = 64
X = SparseTensor(shape, np.stack([rng.integers(0, s, nnz) for s in shape]),
                 rng.standard_normal(nnz))
sk = sharded_sparse_stream_sketch(
    X, left_rank=(4, 4, 4), right_rank=(8, 8, 8), seed=42, mesh=mesh,
    data_axis="data", dtype=torch.float64)
if process_index() == 0:
    np.savez(os.environ["TT_OUT"],
             **{f"psi{i}": P.numpy() for i, P in enumerate(sk.Psi_cores)},
             **{f"omega{i}": O.numpy() for i, O in enumerate(sk.Omega_mats)})
torch.distributed.destroy_process_group()
"""


def test_two_process_sparse_sketch_matches_single(tmp_path):
    out = tmp_path / "multihost_sketch.npz"
    spawn_world(2, ["-c", _WORKER], env_extra={"TT_OUT": str(out)})
    got = np.load(out)
    shape = (6, 5, 4, 6)
    rng = np.random.default_rng(0)
    nnz = 64
    idx = np.stack([rng.integers(0, s, nnz) for s in shape])
    ent = rng.standard_normal(nnz)
    single = stream_sketch(SparseTensor(shape, idx, ent), (4, 4, 4),
                           (8, 8, 8), seed=42,
                           left_drm_type=SparseGaussianDRM,
                           right_drm_type=SparseGaussianDRM)
    ref = jdist.sharded_sparse_stream_sketch(
        JST(shape, idx, ent), left_rank=(4, 4, 4), right_rank=(8, 8, 8),
        seed=42, mesh=JMesh(np.array(jax.devices()[:4]), ("data",)),
        data_axis="data", dtype=jnp.float64)
    ours = ([got[f"psi{i}"] for i in range(4)]
            + [got[f"omega{i}"] for i in range(3)])
    for a, b, c in zip(ours, _parts(single), _parts(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-13)


def test_backend_is_explicit_and_never_falls_back():
    """A backend the build lacks raises; the call does not retry with
    another one."""
    code = (
        "from tt_sketch_torch import config\n"
        "config.set_default_device('cpu')\n"
        "from tt_sketch_torch.dist import initialize_multihost\n"
        "import torch.distributed as dist\n"
        "try:\n"
        "    initialize_multihost(backend='nccl')\n"
        "except Exception as e:\n"
        "    assert not dist.is_initialized(), 'fell back'\n"
        "    print('raised', type(e).__name__, e)\n"
        "else:\n"
        "    raise SystemExit('nccl initialized on a CPU build')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               TT_SKETCH_TORCH_COORDINATOR=f"127.0.0.1:{_free_port()}",
               TT_SKETCH_TORCH_NUM_PROCESSES="1",
               TT_SKETCH_TORCH_PROCESS_ID="0")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "raised" in proc.stdout
