"""Both bisect projections, ``T = X2d @ R`` and ``U = Lᵀ @ X2d``, in one
pass over ``X2d``.

Counterpart of ``tt_sketch_tpu/kernels/pallas_project.py``.  On a CUDA
tensor ``dual_project`` launches the hand-written Hopper kernel of
``tt_sketch_torch/csrc/dual_project.cu`` (built at first use, see
``cuda_build``) or raises; on CPU tensors it computes the plain version
``dual_project_reference``.  There is no fallback from one to the other.
The same library holds the projector diagnostics' kernels
(``projector_diag.py``), which share the operand checks and the bf16
rounding here.
"""
from __future__ import annotations

import functools

import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.kernels import cuda_build
from tt_sketch_torch.kernels.cuda_build import I32, PTR

_COMPUTE = ("f32", "bf16")


def fits_dual_project(P: int, S: int, r: int, rho: int, itemsize: int = 4,
                      block_m: int = 128, block_n: int = 4096) -> bool:
    """The TPU kernel's divisibility gate, kept for parity with
    ``tt_sketch_tpu``.  The CUDA kernel masks ragged edges and takes any
    shape, so nothing in the port consults this."""
    if P % block_m or S % block_n:
        return False
    return P >= block_m and S >= block_n and r >= 1 and rho >= 1


def dual_project_reference(X2d: torch.Tensor, R: torch.Tensor,
                           L: torch.Tensor, compute: str = "f32"):
    """Plain PyTorch version: ``(X2d @ R, L.T @ X2d)`` in the inputs' dtype.

    ``compute="bf16"`` first rounds X2d, R and L to bfloat16 (products then
    accumulate in the inputs' dtype), as the kernel's bf16 mode does.
    """
    X2d, R, L = rounded_operands(compute, X2d, R, L)
    return X2d @ R, L.T @ X2d


def check_compute(compute: str) -> None:
    """Raise unless ``compute`` is a mode the kernels take."""
    if compute not in _COMPUTE:
        raise ValueError(f"compute must be one of {_COMPUTE}, got {compute!r}")


def rounded_operands(compute: str, *tensors):
    """The operands as the kernels' ``compute`` mode sees them: unchanged
    for ``"f32"``, rounded to bfloat16 (and back to their dtype) for
    ``"bf16"``."""
    check_compute(compute)
    if compute == "bf16":
        return tuple(t.to(torch.bfloat16).to(t.dtype) for t in tensors)
    return tensors


def check_cuda_operands(fn: str, X2d, R=None, L=None) -> None:
    """Raise unless X2d (P, S) and the given R (S, ρ) and L (P, r) are
    contiguous 2-D float32 tensors on one CUDA device and X2d is not
    empty; ``fn`` names the caller in the message."""
    named = [("X2d", X2d)] + [(n, t) for n, t in (("R", R), ("L", L))
                              if t is not None]
    for name, t in named:
        if t.device.type != "cuda" or t.device != X2d.device:
            raise ValueError(
                f"{fn}: {name} lies on {t.device}; all operands must "
                f"lie on one CUDA device (X2d is on {X2d.device})"
            )
        if t.dtype != torch.float32:
            raise ValueError(
                f"{fn}: the kernel takes float32, {name} is {t.dtype}"
            )
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous 2-D tensor, got "
                f"shape {tuple(t.shape)} with strides {t.stride()}"
            )
    P, S = X2d.shape
    if (R is not None and R.shape[0] != S) or (L is not None
                                               and L.shape[0] != P):
        shapes = ", ".join(f"{n} {tuple(t.shape)}" for n, t in named)
        raise ValueError(f"{fn}: shapes {shapes} do not chain")
    if P == 0 or S == 0:
        raise ValueError(f"{fn}: X2d is empty")


#: the library's queries of its tile and rank limits (no arguments)
QUERIES = {f"tt_dual_project_{q}": ([], I32)
           for q in ("row_block", "col_tile", "max_r", "max_rho")}


@functools.cache
def _library():
    """The built kernel library with its C signatures declared (once per
    process)."""
    return cuda_build.library("dual_project", {
        "tt_dual_project": ([PTR] * 6 + [I32] * 5 + [PTR], I32), **QUERIES,
    })


@profiling.spanned("tt.kernel.dual_project")
def dual_project(X2d: torch.Tensor, R: torch.Tensor, L: torch.Tensor,
                 compute: str = "f32"):
    """Return ``(X2d @ R, Lᵀ @ X2d)`` with one pass over ``X2d``.

    X2d: (P, S); R: (S, ρ); L: (P, r).  On CUDA all three are contiguous
    float32 on one device, and the kernel multiplies on the tensor cores
    with fp32 accumulation: three TF32 products per product (3xTF32, fp32
    accuracy), or one after ``compute="bf16"`` rounds the operands to
    bfloat16, which TF32 holds exactly.  Ranks above
    the kernel's per-launch limit (r ≤ 32, ρ ≤ 64) are split into several
    launches, each reading X once.  CPU tensors take
    ``dual_project_reference``.  Each launch counts ``launches.dual_project``
    and ``bytes.dual_project`` (``profiling.counters``).
    """
    check_compute(compute)
    if all(t.device.type == "cpu" for t in (X2d, R, L)):
        return dual_project_reference(X2d, R, L, compute)
    check_cuda_operands("dual_project", X2d, R, L)
    lib = _library()
    P, S = X2d.shape
    r, rho = L.shape[1], R.shape[1]
    max_r, max_rho = lib.tt_dual_project_max_r(), lib.tt_dual_project_max_rho()
    row_block, col_tile = (
        lib.tt_dual_project_row_block(), lib.tt_dual_project_col_tile()
    )
    n_blocks = -(-P // row_block)
    s_pad = -(-S // col_tile) * col_tile
    n_launch = max(1, -(-r // max_r), -(-rho // max_rho))
    T_parts, U_parts = [], []
    for c in range(n_launch):
        Lc = L[:, c * max_r:(c + 1) * max_r].contiguous()
        Rc = R[:, c * max_rho:(c + 1) * max_rho].contiguous()
        rc, rhoc = Lc.shape[1], Rc.shape[1]
        Tc = torch.empty((P, rhoc), dtype=torch.float32, device=X2d.device)
        Uc = torch.empty((rc, S), dtype=torch.float32, device=X2d.device)
        Upart = torch.empty(
            (n_blocks, rc, s_pad), dtype=torch.float32, device=X2d.device
        )
        cuda_build.launch(
            lib, "tt_dual_project", X2d.device, X2d.data_ptr(),
            Rc.data_ptr(), Lc.data_ptr(), Tc.data_ptr(), Uc.data_ptr(),
            Upart.data_ptr(), P, S, rc, rhoc, int(compute == "bf16"),
            what="dual_project")
        profiling.launched("dual_project", X2d, Rc, Lc, Tc, Uc)
        T_parts.append(Tc)
        U_parts.append(Uc)
    if n_launch == 1:
        return T_parts[0], U_parts[0]
    return torch.cat(T_parts, dim=1), torch.cat(U_parts, dim=0)

