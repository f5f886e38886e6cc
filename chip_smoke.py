"""Chip smoke test of the PyTorch/H100 port (``tt_sketch_torch``).

Run from the repo root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (the first failure raises and exits non-zero):

1. Build the CUDA libraries ``dual_project``, ``lazy_gaussian`` and
   ``sparse_psi`` from ``tt_sketch_torch/csrc`` (nvcc, sm_90a, one process
   per source, all at once), print each ptxas report and the card's name
   and power limit; count the instructions per DRM sample in the built
   ``lazy_gaussian`` kernel's SASS (the sparse bounds use that count).
2. Hold the kernel against its plain PyTorch version, ``f32`` and ``bf16``
   modes, at the main-path shape, a ragged shape and a rank-split shape;
   time kernel, plain version and the two-``torch.matmul`` yardstick.
3. The main path at full width (``bench.py``'s configuration): a rank-5 TT
   of logical shape (4864, 128, 128, 128), 1.02e10 f32 entries, streamed in
   19 mode-0 slabs kept as their pivot-1 2-D view (32768, 16384) through
   ``slab_stream_sketch`` with TT-DRMs of rank 32/64; recover with
   ``SketchedTensorTrain.to_tt()`` and check the error and the kernel's
   launch count; then time one resident slab streamed 19 x 10 times.
4. ``stream_sketch`` on dense and TT input in float64 at a small shape:
   exact recovery and linearity of ``+``.
5. The sparse main path at full size: ``uber-synthetic`` with its default
   plan, ``stream_sketch`` rank 10/20 with ``SparseGaussianDRM`` in f32,
   recording the arguments of every kernel call; launch counts 3/2/1/1;
   every Ψ/Ω against the same sketch with each kernel replaced by its plain
   version on the card; ``sample_error`` of ``to_tt()``; median sketch time
   over fresh seeds (CUDA events); the recorded segment reductions and slab
   combines replayed and timed; a profiler breakdown.
6. The sparse kernels against their plain versions: the 64-bit hash bit for
   bit; ``lazy_gaussian``, ``omega_fused``, ``psi_fused_slabs`` (three
   variants) and ``psi_omega_merged_slabs`` (two variants) at the calls
   phase 5 recorded (3,309,696 nnz, ranks 10/20, the mode-2/3 plans), at
   the calls of a ragged sketch (nnz not a multiple of the chunk, odd
   ranks) and with flat indices above 2^63; time the recorded calls and
   their plain versions, and bound them.
7. Print the ``{"kernels": [...]}`` line, then the device line last.

Requires CUDA; exits non-zero without it.
"""
import contextlib
import json
import subprocess
import sys
import time

import numpy as np

F32_TOL = 2e-5   # relative Frobenius: fp32 sums of 16384/32768 terms in another order
BF16_TOL = 1e-2  # the same operands rounded to bf16 on both sides, fp32 accumulate
ROWS_TOL = 2e-6  # absolute: FMA-contracted erfinv polynomial vs separate ops, a few f32 ulps at |g| <= 5.5
PSI_TOL = 2e-5   # relative Frobenius: fp32 sums over up to 3.3M nnz in another order
H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12    # H100 SXM data sheet, fp32 outside the tensor cores
# Lane instructions per second of the CUDA cores: the fp32 peak counts an
# FMA as two flops; integer instructions share the same dispatch slots.
H100_LANE_OPS_PER_S = H100_FP32_FLOP_PER_S / 2
LIBRARIES = ("dual_project", "lazy_gaussian", "sparse_psi")
SPARSE_KERNELS = ("lazy_gaussian", "omega_fused", "psi_omega_merged_slabs",
                  "psi_fused_slabs")
RECORDED = SPARSE_KERNELS + ("_psi_sparse_segment", "_psi_from_slabs")
EXPECTED_LAUNCHES = {"lazy_gaussian": 3, "omega_fused": 2,
                     "psi_omega_merged_slabs": 1, "psi_fused_slabs": 1}
REPLACES = {
    "lazy_gaussian": "tt_sketch_tpu/kernels/pallas_rng.py:191",
    "omega_fused": "tt_sketch_tpu/kernels/pallas_psi.py:396",
    "psi_omega_merged_slabs": "tt_sketch_tpu/kernels/pallas_psi.py:498",
    "psi_fused_slabs": "tt_sketch_tpu/kernels/pallas_psi.py:270",
}
SOURCES = {
    "lazy_gaussian": "tt_sketch_torch/csrc/lazy_gaussian.cu",
    "omega_fused": "tt_sketch_torch/csrc/sparse_psi.cu",
    "psi_omega_merged_slabs": "tt_sketch_torch/csrc/sparse_psi.cu",
    "psi_fused_slabs": "tt_sketch_torch/csrc/sparse_psi.cu",
}

MAIN = (32768, 16384, 32, 64)   # (P, S, r, rho) of one slab's pivot-1 view
SHAPES = {"main": MAIN, "ragged": (1000, 3000, 7, 13),
          "rank_split": (777, 5000, 40, 100)}


def _rel(a, b):
    import torch

    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def time_ms(fn, reps=7, warmup=2):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_build():
    from tt_sketch_torch.kernels import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_libraries(LIBRARIES)
    for name in LIBRARIES:
        cuda_build.load_library(name)
    print(f"# phase 1: {', '.join(LIBRARIES)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in LIBRARIES:
        if name in cuda_build.build_info:
            secs, log = cuda_build.build_info[name]
            print(f"# nvcc {name} {secs:.2f} s:")
            for line in log.splitlines():
                print(f"#   {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return smi


def _operands(P, S, r, rho, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((P, S), generator=g, device="cuda", dtype=torch.float32)
    R = torch.randn((S, rho), generator=g, device="cuda", dtype=torch.float32)
    L = torch.randn((P, r), generator=g, device="cuda", dtype=torch.float32)
    return X, R, L


def phase_kernel_check():
    """Kernel vs plain version at every shape and mode; returns the
    measurements at the main-path shape."""
    import torch

    from tt_sketch_torch.kernels.dual_project import (
        dual_project,
        dual_project_reference,
    )

    main = {}
    for seed, (label, (P, S, r, rho)) in enumerate(SHAPES.items()):
        X, R, L = _operands(P, S, r, rho, seed)
        for compute, tol in (("f32", F32_TOL), ("bf16", BF16_TOL)):
            T, U = dual_project(X, R, L, compute=compute)
            T0, U0 = dual_project_reference(X, R, L, compute=compute)
            torch.cuda.synchronize()
            rel = max(_rel(T, T0), _rel(U, U0))
            abs_err = max(float((T - T0).abs().max()),
                          float((U - U0).abs().max()))
            print(f"# phase 2: {label} P={P} S={S} r={r} rho={rho} "
                  f"{compute}: rel err {rel:.3e} (tol {tol:g}), "
                  f"max abs err {abs_err:.3e}")
            if not rel <= tol:
                raise AssertionError(
                    f"dual_project {compute} disagrees with its plain version "
                    f"at {label}: rel err {rel:.3e} > {tol:g}"
                )
            if label == "main":
                main[compute] = {"rel_err": rel, "max_abs_err": abs_err}
        if label == "main":
            for compute in ("f32", "bf16"):
                main[compute]["ms"] = time_ms(
                    lambda: dual_project(X, R, L, compute=compute))
                main[compute]["plain_ms"] = time_ms(
                    lambda: dual_project_reference(X, R, L, compute=compute))
            main["library_ms"] = time_ms(
                lambda: (torch.matmul(X, R), torch.matmul(L.T, X)))
            print(f"# phase 2: main timings (ms): kernel f32 "
                  f"{main['f32']['ms']:.3f}, kernel bf16 "
                  f"{main['bf16']['ms']:.3f}, plain f32 "
                  f"{main['f32']['plain_ms']:.3f}, plain bf16 "
                  f"{main['bf16']['plain_ms']:.3f}, two torch.matmul "
                  f"{main['library_ms']:.3f}")
        del X, R, L
        torch.cuda.empty_cache()
    return main


def phase_main_path():
    """bench.py's configuration through the port's slab stream."""
    import torch

    from tt_sketch_torch import TensorTrain, TensorTrainDRM
    from tt_sketch_torch.engine.sketch import SketchedTensorTrain
    from tt_sketch_torch.formats.tt_ops import tt_to_dense
    from tt_sketch_torch.kernels.dense_engine import (
        dense_stream_sketch_bisect,
        prefix_chain_tensor,
        slab_stream_sketch,
        suffix_chain_tensor,
    )
    from tt_sketch_torch.kernels.dual_project import (
        dual_project,
        dual_project_reference,
    )

    f32 = torch.float32
    slab_shape = (256, 128, 128, 128)
    n_slabs = 19
    shape = (slab_shape[0] * n_slabs,) + slab_shape[1:]
    pivot = 1
    slab2d = (slab_shape[0] * slab_shape[1], slab_shape[2] * slab_shape[3])
    data = TensorTrain.random(shape, 5, seed=0, dtype=f32)
    ld = TensorTrainDRM(32, shape=shape, transpose=False, seed=1, dtype=f32)
    rd = TensorTrainDRM(64, shape=shape, transpose=True, seed=2, dtype=f32)
    s0 = slab_shape[0]

    def slab_fn(i):
        cores = [data.cores[0][:, i * s0:(i + 1) * s0, :]] + data.cores[1:]
        return tt_to_dense(cores).reshape(slab2d).contiguous()

    torch.cuda.synchronize()
    dual_project.launches = 0
    t0 = time.perf_counter()
    container = slab_stream_sketch(
        slab_fn, n_slabs, shape, ld.cores, rd.cores, engine="bisect",
        projector="auto", pivot=pivot,
    )
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = dual_project.launches
    rec = SketchedTensorTrain(container, ld, rd).to_tt()
    err = rec.error(data, relative=True)
    n_entries = float(np.prod(shape))
    print(f"# phase 3: {n_entries:.3e} entries ({n_entries * 4 / 1e9:.1f} GB "
          f"f32) in {n_slabs} slabs of {slab2d}: sketched in {stream_s:.2f} s "
          f"(slabs made from the TT on the card included); dual_project "
          f"launches {launches}; to_tt relative error {err:.3e}")
    if launches != n_slabs:
        raise AssertionError(
            f"dual_project launched {launches} times, expected {n_slabs}")
    if not err <= 1e-3:
        raise AssertionError(f"recovery error {err:.3e} > 1e-3")
    for P in container.Psi_cores:
        if not bool(torch.isfinite(P).all()):
            raise AssertionError("non-finite Psi core")

    # Throughput: one resident slab streamed 19 x 10 times (bench.py:92-105).
    slab = slab_fn(0)
    core0 = ld.cores[0]
    left_rest = list(ld.cores[1:])

    def sketch_slab(i, projector="auto"):
        cores = [core0[:, i * s0:(i + 1) * s0, :]] + left_rest
        return dense_stream_sketch_bisect(
            slab, cores, rd.cores, pivot=pivot, projector=projector,
            shape=slab_shape,
        )

    reps = 10
    sketch_slab(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t_host = time.perf_counter()
    for _ in range(reps):
        for i in range(n_slabs):
            sketch_slab(i)
    enqueue_ms = (time.perf_counter() - t_host) * 1e3 / (reps * n_slabs)
    end.record()
    end.synchronize()
    per_rep_s = start.elapsed_time(end) / 1e3 / reps
    ms_per_slab = per_rep_s / n_slabs * 1e3
    gbps = n_entries * 4 / per_rep_s / 1e9
    entries_per_s = n_entries / per_rep_s
    # Where one slab's time goes: the slab step alone, the projection kernel
    # alone on the same operands, and the slab step with two torch.matmul
    # projections instead of the kernel.
    cores3 = [core0[:, 3 * s0:4 * s0, :]] + left_rest
    L2 = prefix_chain_tensor(cores3, pivot + 1).reshape(slab2d[0], -1).contiguous()
    R2 = suffix_chain_tensor(rd.cores, 2).reshape(slab2d[1], -1).contiguous()
    T, U = dual_project(slab, R2, L2)
    T0, U0 = dual_project_reference(slab, R2, L2)
    slab_rel = max(_rel(T, T0), _rel(U, U0))
    print(f"# phase 3: dual_project on a main-path slab vs plain version: "
          f"rel err {slab_rel:.3e} (tol {F32_TOL:g})")
    if not slab_rel <= F32_TOL:
        raise AssertionError(f"dual_project on a slab: rel err {slab_rel:.3e}")
    del T, U, T0, U0
    slab_ms = time_ms(lambda: sketch_slab(3))
    kernel_ms = time_ms(lambda: dual_project(slab, R2, L2))
    matmul_slab_ms = time_ms(lambda: sketch_slab(3, "matmul"))
    print(f"# phase 3: stream {ms_per_slab:.3f} ms/slab, {gbps:.2f} GB/s, "
          f"{entries_per_s:.4e} entries/s; host enqueue {enqueue_ms:.3f} "
          f"ms/slab")
    print(f"# phase 3: one slab {slab_ms:.3f} ms = dual_project "
          f"{kernel_ms:.3f} ms + rest {slab_ms - kernel_ms:.3f} ms; the slab "
          f"with projector='matmul' {matmul_slab_ms:.3f} ms")
    return {"launches": launches, "rel_err": err, "ms_per_slab": ms_per_slab,
            "gbps": gbps, "entries_per_s": entries_per_s,
            "slab_ms": slab_ms, "stream_s": stream_s}


def phase_stream_sketch():
    import torch

    from tt_sketch_torch import DenseTensor, TensorTrain, stream_sketch

    shape = (8, 5, 6, 7)
    tt = TensorTrain.random(shape, 3, seed=0)
    X = DenseTensor(tt.to_dense())
    err_dense = stream_sketch(X, 4, 7, seed=0).to_tt().error(X, relative=True)
    err_tt = stream_sketch(tt, 4, 7, seed=0).to_tt().error(tt, relative=True)
    X2 = DenseTensor(TensorTrain.random(shape, 3, seed=5).to_dense())
    summed = stream_sketch(X, 4, 7, seed=3) + X2
    direct = stream_sketch(DenseTensor(X.data + X2.data), 4, 7, seed=3)
    lin = max(
        float((a - b).abs().max())
        for a, b in zip(summed.Psi_cores + summed.Omega_mats,
                        direct.Psi_cores + direct.Omega_mats)
    )
    print(f"# phase 4: stream_sketch f64 on {X.data.device}: dense error "
          f"{err_dense:.3e}, TT error {err_tt:.3e}, linearity {lin:.3e}")
    if not (err_dense <= 1e-9 and err_tt <= 1e-9):
        raise AssertionError("stream_sketch recovery error above 1e-9")
    if not lin <= 1e-10:
        raise AssertionError(f"sk + more differs from the sum's sketch: {lin}")
    if X.data.device.type != "cuda" or X.data.dtype != torch.float64:
        raise AssertionError("phase 4 did not run in float64 on the card")


# -- sparse slice --------------------------------------------------------------

def _kernel_fns():
    from tt_sketch_torch.kernels import lazy_gaussian as LG
    from tt_sketch_torch.kernels import sparse_psi as SP

    return {
        "lazy_gaussian": (LG.lazy_gaussian, LG.lazy_gaussian_reference),
        "omega_fused": (SP.omega_fused, SP.omega_fused_reference),
        "psi_omega_merged_slabs": (SP.psi_omega_merged_slabs,
                                   SP.psi_omega_merged_slabs_reference),
        "psi_fused_slabs": (SP.psi_fused_slabs,
                            SP.psi_fused_slabs_reference),
    }


@contextlib.contextmanager
def _patched(mapping):
    """Replace names of ``sketch_kernels`` by ``mapping``'s functions for
    the duration of the block."""
    from tt_sketch_torch.kernels import sketch_kernels as K

    saved = {name: getattr(K, name) for name in mapping}
    for name, fn in mapping.items():
        setattr(K, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


def plain_kernels():
    """Route the fused sparse sketch through every kernel's plain version
    (on the same device) instead of the kernel."""
    return _patched({name: plain for name, (_, plain)
                     in _kernel_fns().items()})


def recording(calls):
    """Record into ``calls`` (name -> list of argument tuples) every call
    the fused sparse sketch makes to the four kernels, to the segment
    reduction and to the slab combine; each call runs as it would."""
    from tt_sketch_torch.kernels import sketch_kernels as K

    def recorder(name, fn):
        def call(*args):
            calls.setdefault(name, []).append(args)
            return fn(*args)
        return call

    return _patched({name: recorder(name, getattr(K, name))
                     for name in RECORDED})


def sass_ops_per_sample():
    """Instructions the built ``lazy_gaussian`` kernel issues per DRM
    sample, counted in its SASS (``cuobjdump -sass``): one walk of the
    sample loop from its head to its back branch that skips the erfinv
    tail block (the one computing sqrtf, ``MUFU.RSQ``; ~0.3 % of samples),
    divided by the stores it passed.  The count includes the loop's own
    bookkeeping and the store."""
    import re
    from pathlib import Path

    from tt_sketch_torch.kernels import cuda_build

    cuobjdump = Path(cuda_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(cuda_build._target("lazy_gaussian"))],
        capture_output=True, text=True, check=True).stdout
    body = next(f for f in sass.split("Function : ")
                if "lazy_gaussian_kernel" in f.splitlines()[0])
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", body)]
    at = {a: i for i, (a, _) in enumerate(ins)}

    def op(t):
        return t.split()[1] if t.startswith("@") else t.split()[0]

    def target(t):
        return at[int(t.split("0x")[-1], 16)]

    def stores(lo, hi):
        return sum(op(t).startswith("STG") for _, t in ins[lo:hi])

    loops = [(i, target(t)) for i, (_, t) in enumerate(ins)
             if op(t) == "BRA" and target(t) < i]
    back, head = max(loops, key=lambda bh: stores(bh[1], bh[0] + 1))
    i, n, n_st = head, 0, 0
    while True:
        n += 1
        n_st += stores(i, i + 1)
        t = ins[i][1]
        if i == back:
            break
        if op(t) == "BRA":
            j = target(t)
            if j <= i:
                raise AssertionError(f"unexpected back branch in the sample "
                                     f"loop at {ins[i][0]:#x}")
            if not t.startswith("@") or any(
                    op(u) == "MUFU.RSQ" for _, u in ins[i + 1:j]):
                i = j
                continue
        i += 1
    if n_st == 0:
        raise AssertionError("no store in the lazy_gaussian sample loop")
    print(f"# phase 1: lazy_gaussian SASS: {n} instructions for {n_st} "
          f"samples per loop trip on the common path = {n / n_st:g} per "
          f"sample")
    return n / n_st


def sparse_bound(name, args, ops_per_sample):
    """(bound ms, bound_by) of one kernel call: each input read once, each
    output written once, over 3.35 TB/s; ``ops_per_sample`` per hashed
    sample plus one multiply per weighted sample and one FMA per contracted
    product, over the CUDA cores' lane-instruction rate."""
    if name == "lazy_gaussian":
        flat, salts = args
        N, R = flat.shape[0], salts.shape[0]
        nbytes = 8 * N + 8 * R + 4 * R * N
        ops = ops_per_sample * R * N
    elif name == "omega_fused":
        e, lflat, rflat, lsalts, rsalts = args
        N, r1, r2 = e.shape[0], lsalts.shape[0], rsalts.shape[0]
        nbytes = 20 * N + 8 * (r1 + r2) + 4 * r1 * r2
        ops = ops_per_sample * (r1 + r2) * N + r1 * N + r1 * r2 * N
    else:
        loc, se, lflat, rflat = args[:4]
        if name == "psi_fused_slabs":
            lsalts, rsalts, nc, span, chunk = args[4:]
            osalts = oflat = None
        else:
            oflat, lsalts, rsalts, osalts, nc, span, chunk = args[4:]
        N = se.shape[0]
        r1 = lsalts.shape[0] if lflat is not None else 1
        r2 = rsalts.shape[0] if rflat is not None else 1
        hashed = (r1 if lflat is not None else 0) + (
            r2 if rflat is not None else 0)
        n_flat = (lflat is not None) + (rflat is not None)
        nbytes = (4 * loc.shape[0] + 4 * N + 8 * n_flat * N + 8 * hashed
                  + 4 * nc * span * r1 * r2)
        ops = ops_per_sample * hashed * N + r1 * N + r1 * r2 * N
        if oflat is not None:
            r1o = osalts.shape[0]
            nbytes += 8 * N + 8 * r1o + 4 * r1o * r2
            ops += ops_per_sample * r1o * N + r1o * N + r1o * r2 * N
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_LANE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _compare(name, label, got, ref):
    """(max abs err, rel err) of a kernel's outputs against its plain
    version's; raises past the tolerance."""
    import torch

    abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    rel = max(_rel(g, r) for g, r in zip(got, ref))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    if name == "lazy_gaussian":
        ok, tol = abs_err <= ROWS_TOL, f"abs tol {ROWS_TOL:g}"
    else:
        ok, tol = rel <= PSI_TOL, f"rel tol {PSI_TOL:g}"
    print(f"# phase 6: {name} {label}: max abs err {abs_err:.3e}, rel err "
          f"{rel:.3e} ({tol}), finite {finite}")
    if not (ok and finite):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{label}")
    return abs_err, rel


def _high_flats(args, offset):
    """The same call with every flat index stream shifted by ``offset``
    (mod 2^64), which puts them above 2^63."""
    import torch

    def shift(a):
        if isinstance(a, torch.Tensor) and a.dtype == torch.int64 \
                and a.ndim == 1 and a.shape[0] > 1 << 16:
            return a + offset
        return a

    return tuple(shift(a) for a in args)


def _ragged_case():
    """A small tensor whose nnz is not a multiple of the chunk, with a
    chunk that is not a multiple of the kernels' tile, odd ranks, and one
    unplanned mode (so all four kernels run)."""
    from tt_sketch_torch import SparseGaussianDRM
    from tt_sketch_torch.formats import SparseTensor

    rng = np.random.default_rng(3)
    shape = (13, 7, 150, 101)
    nnz = 40_009
    idx = np.stack([rng.integers(0, n, nnz) for n in shape])
    ent = rng.standard_normal(nnz).astype(np.float32)
    t = SparseTensor(shape, idx, ent, device="cuda").with_psi_plan(
        indices=idx, entries=ent, threshold=10, chunk=1000)
    import torch

    ldrm = SparseGaussianDRM(7, shape, transpose=False, seed=11,
                             dtype=torch.float32, device="cuda")
    rdrm = SparseGaussianDRM(13, shape, transpose=True, seed=12,
                             dtype=torch.float32, device="cuda")
    return t, ldrm, rdrm


def phase_sparse_kernels(main_calls, ops_per_sample):
    """Each sparse kernel against its plain version at the calls the main
    path made (``main_calls``, recorded in phase 5), at a ragged sketch's
    calls and with flat indices above 2^63; times and bounds of the main
    path's calls."""
    import torch

    from tt_sketch_torch import stream_sketch
    from tt_sketch_torch.kernels.lazy_gaussian import hash_bits
    from tt_sketch_torch.rng.hash_rng import hash_int, hash_int_np

    # the bare 64-bit hash, bit for bit, including values above 2^63
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randint(-(1 << 62), 1 << 62, (1 << 20,), generator=g,
                      device="cuda", dtype=torch.int64) * 2 + 1
    x[:4] = torch.tensor([0, -1, 30787972, -(1 << 63)], device="cuda")
    hb = hash_bits(x)
    same_dev = bool((hb == hash_int(x)).all())
    xs = x[:4096].cpu().numpy()
    same_host = bool((hb[:4096].cpu().numpy().view(np.uint64)
                      == hash_int_np(xs.view(np.uint64))).all())
    print(f"# phase 6: hash64 kernel vs plain int64 hash on the card: "
          f"{'equal' if same_dev else 'DIFFERENT'} over {x.shape[0]} "
          f"values; vs numpy uint64 on the host: "
          f"{'equal' if same_host else 'DIFFERENT'}")
    if not (same_dev and same_host):
        raise AssertionError("the 64-bit hash kernel disagrees bit for bit")

    fns = _kernel_fns()
    cases = [("uber", main_calls)]
    rt, rl, rr = _ragged_case()
    ragged_calls = {}
    with recording(ragged_calls):
        stream_sketch(rt, rl.rank, rr.rank, left_drm=rl, right_drm=rr,
                      dtype=torch.float32)
    cases.append(("ragged", ragged_calls))
    high = {n: [_high_flats(a, -(1 << 63) + 12345) for a in main_calls[n]]
            for n in SPARSE_KERNELS}
    cases.append(("flats>2^63", high))
    # the u24 = 2^24-1 input: salt + flat == 30787972 hashes to the top
    # quantile (the extreme is finite only if x is formed in int32)
    salts = main_calls["lazy_gaussian"][0][1]
    top = torch.full((1,), 30787972, dtype=torch.int64, device="cuda") - \
        salts[:1]
    cases.append(("u24=2^24-1", {"lazy_gaussian": [(top, salts[:1])]}))

    res = {}
    for label, calls in cases:
        for name in SPARSE_KERNELS:
            kern, plain = fns[name]
            for i, args in enumerate(calls.get(name, [])):
                got = _as_tuple(kern(*args))
                ref = _as_tuple(plain(*args))
                torch.cuda.synchronize()
                a, r = _compare(name, f"{label} call {i}", got, ref)
                if label == "uber":
                    m = res.setdefault(name, {"max_abs_err": 0.0,
                                              "rel_err": 0.0})
                    m["max_abs_err"] = max(m["max_abs_err"], a)
                    m["rel_err"] = max(m["rel_err"], r)
        if label == "ragged":
            # the variants the main path does not launch: Ψ with both
            # sides and without a left side, merged without a left side
            p = rt.psi_plan[2]
            d = len(rt.shape)
            lsalts, rsalts = rl.salts(1), rr.salts(d - 2 - 2)
            extra = [
                ("psi_fused_slabs", (p.local_idx, p.sorted_entries,
                                     p.flat_left, p.flat_right, lsalts,
                                     rsalts, p.n_chunks, p.span, p.chunk)),
                ("psi_fused_slabs", (p.local_idx, p.sorted_entries, None,
                                     p.flat_right, None, rsalts, p.n_chunks,
                                     p.span, p.chunk)),
                ("psi_omega_merged_slabs", (
                    p.local_idx, p.sorted_entries, None, p.flat_right,
                    p.flat_left_om, None, rsalts, rl.salts(2), p.n_chunks,
                    p.span, p.chunk)),
            ]
            for name, args in extra:
                kern, plain = fns[name]
                got, ref = _as_tuple(kern(*args)), _as_tuple(plain(*args))
                torch.cuda.synchronize()
                _compare(name, "ragged variant", got, ref)

    # times of each kernel's main-path launches (one sketch's worth)
    for name in SPARSE_KERNELS:
        kern, plain = fns[name]
        calls = main_calls[name]
        res[name]["ms"] = time_ms(lambda: [kern(*a) for a in calls])
        res[name]["plain_ms"] = time_ms(
            lambda: [plain(*a) for a in calls], reps=3, warmup=1)
        bounds = [sparse_bound(name, a, ops_per_sample) for a in calls]
        res[name]["bound_ms"] = sum(b for b, _ in bounds)
        res[name]["bound_by"] = max(bounds)[1]
        res[name]["calls"] = len(calls)
        print(f"# phase 6: {name}: {len(calls)} main-path launch(es) in "
              f"{res[name]['ms']:.3f} ms (bound {res[name]['bound_ms']:.3f} "
              f"ms by {res[name]['bound_by']}), plain version "
              f"{res[name]['plain_ms']:.3f} ms")
    return res


def profile_sketch(run, n=3):
    """Device time by kernel over ``n`` sketches (``torch.profiler``) and
    the device's busy share of the window (kernel time over the CUDA-event
    time of the window; one stream, so kernels do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for s in range(n):
            run(s + 1)
        end.record()
        end.synchronize()
    window_us = start.elapsed_time(end) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies, memsets): an operator's CPU
    # event repeats the time of the kernels it launched
    rows = sorted(((device_us(e), e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and device_us(e) > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"# phase 5: profiler over {n} sketches: device busy "
          f"{busy_us / 1e3:.3f} ms of a {window_us / 1e3:.3f} ms window "
          f"({100 * busy_us / window_us:.1f} % busy); per sketch, by "
          f"device time:")
    for us, count, key in rows[:14]:
        print(f"#   {us / 1e3 / n:9.3f} ms  {count // n:4d} x  {key[:90]}")
    return busy_us / window_us


def load_uber():
    """uber-synthetic with its default plans, on the card in f32."""
    import torch

    from tt_sketch_torch.data.frostt import load_frostt

    t0 = time.perf_counter()
    tensor = load_frostt("uber-synthetic", psi_plan=True,
                         device="cuda").astype(torch.float32)
    torch.cuda.synchronize()
    print(f"# uber-synthetic {tensor.shape}, {tensor.nnz} nnz, plans "
          f"{tensor.psi_plan}, loaded, planned and moved to the card in "
          f"{time.perf_counter() - t0:.2f} s")
    return tensor


def phase_sparse_main(tensor):
    """uber-synthetic through stream_sketch and the sparse kernels; returns
    the measurements and the arguments of every kernel, segment-reduction
    and slab-combine call of the counted sketch."""
    import torch

    from tt_sketch_torch import SparseGaussianDRM, stream_sketch
    from tt_sketch_torch.data.frostt import sample_error
    from tt_sketch_torch.kernels import sketch_kernels as K

    kw = dict(left_drm_type=SparseGaussianDRM,
              right_drm_type=SparseGaussianDRM, dtype=torch.float32)
    fns = _kernel_fns()

    calls = {}
    torch.cuda.synchronize()
    for kern, _ in fns.values():
        kern.launches = 0
    with recording(calls):
        sk, ldrm, rdrm = stream_sketch(tensor, 10, 20, seed=0,
                                       return_drm=True, **kw)
    torch.cuda.synchronize()
    launches = {name: fns[name][0].launches for name in SPARSE_KERNELS}
    print(f"# phase 5: kernel launches in one sketch: {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {launches} != "
                             f"{EXPECTED_LAUNCHES}")
    with plain_kernels():
        ref = stream_sketch(tensor, 10, 20, left_drm=ldrm, right_drm=rdrm,
                            **kw)
    torch.cuda.synchronize()
    worst = 0.0
    for i, (a, b) in enumerate(zip(sk.Psi_cores + sk.Omega_mats,
                                   ref.Psi_cores + ref.Omega_mats)):
        if not (bool(torch.isfinite(a).all())
                and bool(torch.isfinite(b).all())):
            raise AssertionError(f"non-finite sketch part {i}")
        worst = max(worst, _rel(a, b))
    print(f"# phase 5: every Psi/Omega vs the plain-version sketch on the "
          f"card: worst rel err {worst:.3e} (tol {PSI_TOL:g})")
    if not worst <= PSI_TOL:
        raise AssertionError(f"sketch disagrees with its plain version: "
                             f"{worst:.3e}")
    err = sample_error(sk.to_tt(), tensor)
    print(f"# phase 5: sample_error(to_tt()) = {err:.4f} (limit 1.0)")
    if not err <= 1.0:
        raise AssertionError(f"sample error {err:.4f} > 1.0")

    def run(seed):
        return stream_sketch(tensor, 10, 20, seed=seed, **kw)

    run(1)
    torch.cuda.synchronize()
    times, inner = [], 5
    for i in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for j in range(inner):
            run(100 + inner * i + j)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    med = float(np.median(times))
    # host enqueue of one sketch (no synchronization inside the sketch)
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    run(7)
    enqueue_ms = (time.perf_counter() - t_host) * 1e3
    torch.cuda.synchronize()
    with plain_kernels():
        plain_ms = time_ms(lambda: run(3), reps=3, warmup=1)
    # the parts outside the kernels, replayed from the counted sketch: the
    # segment reductions of unplanned modes, the slab combines of planned
    # ones
    seg_ms = time_ms(lambda: [K._psi_sparse_segment(*a)
                              for a in calls["_psi_sparse_segment"]])
    comb_ms = time_ms(lambda: [K._psi_from_slabs(*a)
                               for a in calls["_psi_from_slabs"]])
    busy = profile_sketch(lambda s: run(200 + s))
    nnz_per_s = tensor.nnz / (med / 1e3)
    print(f"# phase 5: sketch median {med:.3f} ms over fresh seeds "
          f"({', '.join(f'{t:.3f}' for t in times)}), "
          f"sparse_stta_nnz_per_s {nnz_per_s:.6e}; host enqueue of one "
          f"sketch {enqueue_ms:.3f} ms; plain-version sketch {plain_ms:.3f} "
          f"ms; segment reductions "
          f"({len(calls['_psi_sparse_segment'])} modes) {seg_ms:.3f} ms; "
          f"slab combines ({len(calls['_psi_from_slabs'])} modes) "
          f"{comb_ms:.3f} ms; device busy {100 * busy:.1f} %")
    return {"launches": launches, "busy": busy, "ms": med, "times": times,
            "nnz_per_s": nnz_per_s, "sample_error": err, "worst_rel": worst,
            "plain_ms": plain_ms, "enqueue_ms": enqueue_ms, "seg_ms": seg_ms,
            "comb_ms": comb_ms, "calls": calls}


def bound_ms(P, S, r, rho):
    nbytes = 4 * (P * S + S * rho + P * r + P * rho + r * S)
    flops = 2 * P * S * (r + rho)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), t_bytes, t_ops


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    import tt_sketch_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = phase_build()
    ops_per_sample = sass_ops_per_sample()
    kern = phase_kernel_check()
    path = phase_main_path()
    phase_stream_sketch()
    sparse = phase_sparse_main(load_uber())
    skern = phase_sparse_kernels(sparse["calls"], ops_per_sample)

    b_ms, b_by, b_bytes, b_ops = bound_ms(*MAIN)
    entry = {
        "name": "dual_project",
        "route": "cuda",
        "source": "tt_sketch_torch/csrc/dual_project.cu",
        "replaces": "tt_sketch_tpu/kernels/pallas_project.py:74",
        "launches": path["launches"],
        "max_abs_err": kern["f32"]["max_abs_err"],
        "max_rel_err": kern["f32"]["rel_err"],
        "ms": kern["f32"]["ms"],
        "plain_ms": kern["f32"]["plain_ms"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": kern["library_ms"],
        "bound_bytes_ms": b_bytes,
        "bound_ops_ms": b_ops,
        "bf16_ms": kern["bf16"]["ms"],
        "bf16_plain_ms": kern["bf16"]["plain_ms"],
        "bf16_max_rel_err": kern["bf16"]["rel_err"],
        "shape": dict(zip(("P", "S", "r", "rho"), MAIN)),
        "card": smi,
    }
    entries = [entry]
    for name in SPARSE_KERNELS:
        m = skern[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sparse["launches"][name],
            "max_abs_err": m["max_abs_err"],
            "max_rel_err": m["rel_err"],
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"],
            "library_ms": None,
            "bound_ops_per_sample": ops_per_sample,
            "shape": "FROSTT-uber main path, 3309696 nnz, rank 10/20; ms "
                     "and bound cover all launches of one sketch",
            "card": smi,
        })
    print(f"# main path: {path['gbps']:.2f} GB/s, {path['ms_per_slab']:.3f} "
          f"ms/slab, recovery error {path['rel_err']:.3e}")
    print(f"# sparse main path: {sparse['ms']:.3f} ms per uber sketch, "
          f"sparse_stta_nnz_per_s {sparse['nnz_per_s']:.6e}, sample error "
          f"{sparse['sample_error']:.4f}; total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
