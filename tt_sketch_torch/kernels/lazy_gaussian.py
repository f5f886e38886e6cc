"""Lazy-Gaussian DRM rows ``(R, N)`` from flat indices and column salts.

Counterpart of ``tt_sketch_tpu/kernels/pallas_rng.py``
(``_generate_pairs`` / ``lazy_gaussian_pallas_from_salts``).  On CUDA
tensors ``lazy_gaussian`` launches the hand-written kernel of
``tt_sketch_torch/csrc/lazy_gaussian.cu`` (built at first use, see
``cuda_build``) or raises; on CPU tensors it computes the plain version
``lazy_gaussian_reference``.  There is no fallback from one to the other.

``hash_bits`` exports the kernel's bare 64-bit hash (``tt_hash_bits``) for
holding the device's integer arithmetic against ``hash_rng.hash_int``.
"""
from __future__ import annotations

import functools

import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.kernels import cuda_build
from tt_sketch_torch.kernels.cuda_build import I32, I64, PTR, check_int64
from tt_sketch_torch.rng.hash_rng import hash_int, normal_from_bits

#: (rows of) flat indices processed per step of the plain version
_REF_BLOCK = 1 << 20


def lazy_gaussian_reference(flat: torch.Tensor,
                            salts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``out[r, n] = normal(hash(flat[n] +
    salts[r]))`` as float32, the kernel contract of ``hash_rng``."""
    out = torch.empty((salts.shape[0], flat.shape[0]), dtype=torch.float32,
                      device=flat.device)
    for n0 in range(0, flat.shape[0], _REF_BLOCK):
        f = flat[n0:n0 + _REF_BLOCK]
        out[:, n0:n0 + _REF_BLOCK] = normal_from_bits(
            hash_int(f[None, :] + salts[:, None]))
    return out


@functools.cache
def _library():
    """The built kernel library with its C signatures declared (once per
    process)."""
    return cuda_build.library("lazy_gaussian", {
        "tt_lazy_gaussian": ([PTR, PTR, PTR, I64, I32, PTR], I32),
        "tt_hash_bits": ([PTR, PTR, I64, PTR], I32),
        "tt_lazy_gaussian_max_rows": ([], I32),
    })


@profiling.spanned("tt.kernel.lazy_gaussian")
def lazy_gaussian(flat: torch.Tensor, salts: torch.Tensor) -> torch.Tensor:
    """(R, N) float32 lazy-Gaussian rows for int64 ``flat`` (N,) and int64
    column ``salts`` (R,) (``hash_rng.drm_salts``).

    CPU tensors take ``lazy_gaussian_reference``; CUDA tensors launch the
    kernel (counted as ``launches.lazy_gaussian``, ``bytes.lazy_gaussian``)."""
    if flat.device.type == "cpu" and salts.device.type == "cpu":
        return lazy_gaussian_reference(flat, salts)
    for name, t in (("flat", flat), ("salts", salts)):
        check_int64(name, t, flat.device)
    if flat.device.type != "cuda":
        raise ValueError(f"lazy_gaussian: no kernel for {flat.device}")
    lib = _library()
    N, R = flat.shape[0], salts.shape[0]
    if R > lib.tt_lazy_gaussian_max_rows():
        raise ValueError(
            f"lazy_gaussian: {R} rows > the kernel's "
            f"{lib.tt_lazy_gaussian_max_rows()}")
    out = torch.empty((R, N), dtype=torch.float32, device=flat.device)
    if N == 0 or R == 0:
        return out
    cuda_build.launch(lib, "tt_lazy_gaussian", flat.device, flat.data_ptr(),
                      salts.data_ptr(), out.data_ptr(), N, R,
                      what="lazy_gaussian")
    profiling.launched("lazy_gaussian", flat, salts, out)
    return out


@profiling.spanned("tt.kernel.hash_bits")
def hash_bits(x: torch.Tensor) -> torch.Tensor:
    """The 64-bit hash of int64 bit patterns: ``hash_int`` on the CPU, the
    kernel library's ``tt_hash_bits`` on CUDA (``launches.hash_bits``)."""
    if x.device.type == "cpu":
        return hash_int(x)
    check_int64("x", x, x.device)
    lib = _library()
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    cuda_build.launch(lib, "tt_hash_bits", x.device, x.data_ptr(),
                      out.data_ptr(), x.shape[0], what="hash_bits")
    profiling.launched("hash_bits", x, out)
    return out

