"""Chip smoke test of the PyTorch/H100 port (``tt_sketch_torch``).

Run from the repo root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (the first failure raises and exits non-zero):

1. Build the ``dual_project`` CUDA kernel from ``tt_sketch_torch/csrc``
   (nvcc, sm_90a) and print the card's name and power limit.
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
5. Print the ``{"kernels": [...]}`` line, then the device line last.

Requires CUDA; exits non-zero without it.
"""
import json
import subprocess
import sys
import time

import numpy as np

F32_TOL = 2e-5   # relative Frobenius: fp32 sums of 16384/32768 terms in another order
BF16_TOL = 1e-2  # the same operands rounded to bf16 on both sides, fp32 accumulate
H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12    # H100 SXM data sheet, fp32 outside the tensor cores

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
    cuda_build.load_library("dual_project")
    print(f"# phase 1: dual_project built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    if "dual_project" in cuda_build.build_info:
        secs, log = cuda_build.build_info["dual_project"]
        print(f"# nvcc {secs:.2f} s:")
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
    kern = phase_kernel_check()
    path = phase_main_path()
    phase_stream_sketch()

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
    print(f"# main path: {path['gbps']:.2f} GB/s, {path['ms_per_slab']:.3f} "
          f"ms/slab, recovery error {path['rel_err']:.3e}; total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
