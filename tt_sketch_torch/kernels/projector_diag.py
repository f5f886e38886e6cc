"""The projector diagnostics: ``T = X2d @ R`` alone, ``U = Lᵀ @ X2d`` alone
and a read-once row sum of ``X2d``, set beside ``dual_project`` and the
library's products.

Counterpart of ``scripts/bench_projector_diag.py`` (``t_only``, ``u_only``,
``reduce_read`` and ``main``).  They split ``dual_project``'s time into
what reading X costs (``reduce_read``, the card's read floor), what each
product costs alone, and what fusing the two costs.  ``t_only`` and
``u_only`` are ``dual_project``'s own kernel with one half switched off
(``csrc/dual_project.cu``: same tile, block, rounding, U partials and rank
limits); ``reduce_read`` is a kernel of the same library.

On CUDA tensors each entry point launches its hand-written kernel or
raises; on CPU tensors it computes the plain version beside it.  There is
no fallback from one to the other.  Each entry point counts its kernel
launches and bytes as ``launches.<name>`` and ``bytes.<name>``
(``profiling.counters``).

Run the diagnostics on the card at one slab's 2-D view (the dense main
path's shape)::

    python -m tt_sketch_torch.kernels.projector_diag

Not carried over from the script: its ``sem="parallel"`` variant of
``t_only`` (TPU megacore dimension semantics; the H100 has no such switch)
and its block-size sweep of ``dual_project`` (the port's tiles are fixed).
"""
from __future__ import annotations

import functools
import time

import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.kernels import cuda_build
from tt_sketch_torch.kernels.cuda_build import I32, PTR
from tt_sketch_torch.kernels.dual_project import (
    QUERIES,
    check_compute,
    check_cuda_operands,
    dual_project,
    rounded_operands,
)

#: (P, S, r, ρ) of one slab's 2-D view on the dense main path: X is
#: (32768, 16384) f32, 2.147 GB
MAIN_SHAPE = (32768, 16384, 32, 64)
TAGS = ("read-roofline", "lib-T", "lib-U", "T-f32", "T-bf16", "U-f32",
        "U-bf16", "dual-f32", "dual-bf16")


@functools.cache
def _library():
    """The projection library (``dual_project``'s) with the C signatures
    of the diagnostics' kernels declared (once per process)."""
    return cuda_build.library("dual_project", {
        "tt_t_only": ([PTR] * 3 + [I32] * 4 + [PTR], I32),
        "tt_u_only": ([PTR] * 4 + [I32] * 4 + [PTR], I32),
        "tt_reduce_read": ([PTR] * 2 + [I32] * 2 + [PTR], I32), **QUERIES,
    })


def t_only_reference(X2d: torch.Tensor, R: torch.Tensor,
                     compute: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of ``t_only``: ``X2d @ R``; ``compute="bf16"``
    rounds both operands to bfloat16 first."""
    X2d, R = rounded_operands(compute, X2d, R)
    return X2d @ R


def u_only_reference(X2d: torch.Tensor, L: torch.Tensor,
                     compute: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of ``u_only``: ``Lᵀ @ X2d``; ``compute="bf16"``
    rounds both operands to bfloat16 first."""
    X2d, L = rounded_operands(compute, X2d, L)
    return L.T @ X2d


def reduce_read_reference(X2d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``reduce_read``: the (P, 1) row sums."""
    return X2d.sum(dim=1, keepdim=True)


def in_rank_blocks(fn, side: torch.Tensor, step: int, dim: int):
    """``fn`` of each block of at most ``step`` columns of ``side``, the
    results concatenated along ``dim``: how a rank above a kernel's
    per-launch limit becomes several launches.  A side without columns is
    one block."""
    parts = [fn(side[:, c0:c0 + step].contiguous())
             for c0 in range(0, max(side.shape[1], 1), step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


@profiling.spanned("tt.kernel.t_only")
def t_only(X2d: torch.Tensor, R: torch.Tensor,
           compute: str = "f32") -> torch.Tensor:
    """Return ``X2d @ R`` (P, ρ) through the T half of ``dual_project``'s
    kernel.  ρ above the per-launch limit (64) is split into several
    launches, each reading X once.  CPU tensors take ``t_only_reference``."""
    check_compute(compute)
    if X2d.device.type == "cpu" and R.device.type == "cpu":
        return t_only_reference(X2d, R, compute)
    check_cuda_operands("t_only", X2d, R=R)
    lib = _library()
    P, S = X2d.shape

    def launch(Rc):
        T = torch.empty((P, Rc.shape[1]), dtype=torch.float32,
                        device=X2d.device)
        cuda_build.launch(
            lib, "tt_t_only", X2d.device, X2d.data_ptr(), Rc.data_ptr(),
            T.data_ptr(), P, S, Rc.shape[1], int(compute == "bf16"),
            what="t_only")
        profiling.launched("t_only", X2d, Rc, T)
        return T

    return in_rank_blocks(launch, R, lib.tt_dual_project_max_rho(), dim=1)


@profiling.spanned("tt.kernel.u_only")
def u_only(X2d: torch.Tensor, L: torch.Tensor,
           compute: str = "f32") -> torch.Tensor:
    """Return ``Lᵀ @ X2d`` (r, S) through the U half of ``dual_project``'s
    kernel: one partial per block of the kernel's rows
    (``tt_dual_project_row_block``), summed in a fixed order by a second
    kernel.  r above the per-launch limit (32) is split into several
    launches.  CPU tensors take ``u_only_reference``."""
    check_compute(compute)
    if X2d.device.type == "cpu" and L.device.type == "cpu":
        return u_only_reference(X2d, L, compute)
    check_cuda_operands("u_only", X2d, L=L)
    lib = _library()
    P, S = X2d.shape
    n_blocks = -(-P // lib.tt_dual_project_row_block())
    col_tile = lib.tt_dual_project_col_tile()
    s_pad = -(-S // col_tile) * col_tile

    def launch(Lc):
        r = Lc.shape[1]
        U = torch.empty((r, S), dtype=torch.float32, device=X2d.device)
        Upart = torch.empty((n_blocks, r, s_pad), dtype=torch.float32,
                            device=X2d.device)
        cuda_build.launch(
            lib, "tt_u_only", X2d.device, X2d.data_ptr(), Lc.data_ptr(),
            U.data_ptr(), Upart.data_ptr(), P, S, r, int(compute == "bf16"),
            what="u_only")
        profiling.launched("u_only", X2d, Lc, U)
        return U

    return in_rank_blocks(launch, L, lib.tt_dual_project_max_r(), dim=0)


@profiling.spanned("tt.kernel.reduce_read")
def reduce_read(X2d: torch.Tensor) -> torch.Tensor:
    """Return the (P, 1) row sums of ``X2d`` from one read of it: the
    card's read floor for X.  CPU tensors take ``reduce_read_reference``."""
    device = X2d.device
    if device.type == "cpu":
        return reduce_read_reference(X2d)
    check_cuda_operands("reduce_read", X2d)
    lib = _library()
    P, S = X2d.shape
    out = torch.empty((P, 1), dtype=torch.float32, device=device)
    cuda_build.launch(lib, "tt_reduce_read", device, X2d.data_ptr(),
                      out.data_ptr(), P, S, what="reduce_read")
    profiling.launched("reduce_read", X2d, out)
    return out


def _diag_calls(X2d, R, L):
    """tag -> the call it times, as ``scripts/bench_projector_diag.py:main``
    runs them; ``lib-*`` are the library's products (the script's
    ``xla-*``)."""
    return {
        "read-roofline": lambda: reduce_read(X2d),
        "lib-T": lambda: torch.matmul(X2d, R),
        "lib-U": lambda: torch.matmul(L.T, X2d),
        "T-f32": lambda: t_only(X2d, R),
        "T-bf16": lambda: t_only(X2d, R, compute="bf16"),
        "U-f32": lambda: u_only(X2d, L),
        "U-bf16": lambda: u_only(X2d, L, compute="bf16"),
        "dual-f32": lambda: dual_project(X2d, R, L),
        "dual-bf16": lambda: dual_project(X2d, R, L, compute="bf16"),
    }


def _timed(fn, reps, cuda):
    """(ms per call, the last call's output) over ``reps`` calls after one
    untimed call: CUDA events on the card, the host clock on the CPU."""
    fn()
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def run_projector_diag(X2d: torch.Tensor, R: torch.Tensor, L: torch.Tensor,
                       reps: int = 8) -> dict:
    """Time each tag of ``TAGS`` on ``(X2d, R, L)``: one untimed call, then
    ``reps`` calls (CUDA events on the card; the host clock on CPU tensors,
    which take the plain versions).  The library's products run with TF32
    off.  Prints one line per tag, ``[tag] ms  GB/s``, as the script does,
    and returns tag -> ``{"ms", "gbps", "out"}``: ms per call, GB/s over
    X2d's bytes and the last call's output."""
    cuda = X2d.device.type == "cuda"
    xbytes = X2d.numel() * X2d.element_size()
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for tag, fn in _diag_calls(X2d, R, L).items():
            ms, out = _timed(fn, reps, cuda)
            res[tag] = {"ms": ms, "gbps": xbytes / (ms / 1e3) / 1e9,
                        "out": out}
            print(f"[{tag}] {ms:.3f} ms  {res[tag]['gbps']:.1f} GB/s",
                  flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return res


def main() -> dict:
    """Run the diagnostics on the card at ``MAIN_SHAPE`` with random
    operands from seed 0."""
    if not torch.cuda.is_available():
        raise SystemExit("projector_diag: no CUDA card")
    P, S, r, rho = MAIN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    X, R, L = (torch.randn(shape, generator=g, device="cuda")
               for shape in ((P, S), (S, rho), (P, r)))
    print(f"# projector diagnostics on {torch.cuda.get_device_name()}: "
          f"P={P} S={S} r={r} rho={rho}, X {X.numel() * 4 / 1e9:.3f} GB f32")
    return run_projector_diag(X, R, L)


if __name__ == "__main__":
    main()
