"""Batched one-sided Jacobi SVD of small matrices, ``A = U diag(s) Vh``.

Counterpart of ``tt_sketch_tpu/kernels/accurate_linalg.jacobi_svd``
(one-sided Hestenes, round-robin pairs, at most 12 sweeps).  On CUDA
tensors ``jacobi_svd`` launches the hand-written kernel of
``tt_sketch_torch/csrc/jacobi_svd.cu`` (built at first use, see
``cuda_build``) or raises; on CPU tensors it computes the plain version
``jacobi_svd_reference``, the same sweeps in batched tensor code.  There is
no fallback from one to the other.

One block factors one matrix with everything in its shared memory; a
matrix fits when that does (``jacobi_fits``).  The recovery (``utils._lstsq``)
routes by that rule: a CUDA matrix that fits takes the kernel, anything
else ``torch.linalg.svd``.  The kernel is latency-bound: about ``2 n +
(n_p - 1) x sweeps`` block barriers a matrix (n_p: n rounded up to even),
whatever its bytes or flops.

Both versions scale by ``max|A|`` first, precondition by a Householder QR
with column pivoting (``A P = Q R``, each step the column of largest norm
below the rows done; the JAX function does not precondition: its sweeps on
A take 12-16 for graded or rank-deficient matrices, those on an unpivoted
``R^T`` 6-10 in float32 and 8-12 for float64 30 x 30 at cond 1e6, those on
the pivoted one 6-9 and 7-10), then sweep over ``W = P R^T``: rotate a pair
(p, q) of its columns when ``|w_p . w_q| > eps * sqrt(m) * |w_p| |w_q|``
(m the rows once a wide matrix is transposed; LAPACK's ``sgesvj``
tolerance, which sets the sweeps: eps·m saved about one and left float32
solves less accurate), by Rutishauser's formulas, and stop a matrix after
the first sweep that rotates nothing.  A non-finite entry gives non-finite
singular values and vectors, as the JAX function gives.
"""
from __future__ import annotations

import functools
import math

import torch

from tt_sketch_torch import profiling
from tt_sketch_torch.kernels import cuda_build
from tt_sketch_torch.kernels.cuda_build import I32, I64, PTR

#: the kernel's limits (``csrc/jacobi_svd.cu``, held to it by a card test):
#: sweeps at most, the shared memory of a block (the default limit), and
#: columns at most (16 warps of four 8-lane groups, a column each)
MAX_SWEEPS = 12
SMEM_BUDGET = 48 * 1024
MAX_COLS = 64


def smem_bytes(elem: int, m: int, n: int) -> int:
    """Shared memory of the kernel's block for an m x n matrix (m >= n) in
    ``elem``-byte values (``smem_bytes`` of ``csrc/jacobi_svd.cu``): the
    reflectors (n columns of m rows rounded up to chunks of ``8 * 16 /
    elem`` rows), W = R^T (``n_p`` columns of 1, 2 or 4 chunks, n_p = n
    rounded up to even) in a region that later holds U (as the reflectors),
    Z (as W), the column norms, the reflectors' factors, R's diagonal, 32
    warp maxima and the order of the columns."""
    np_, ch = n + (n & 1), 128 // elem
    chunks = -(-np_ // ch)
    an = -(-m // ch) * ch * n
    wz = (1 if chunks <= 1 else 2 if chunks <= 2 else 4) * ch * np_
    return elem * (an + max(an, wz) + wz + np_ + 2 * n + 32) + 4 * np_


def jacobi_fits(m: int, n: int, dtype) -> bool:
    """Whether the kernel takes an m x n matrix (either orientation) of
    ``dtype``: float32 or float64, its smaller side 1 to ``MAX_COLS``, and
    its block's shared memory (``smem_bytes`` of the matrix with its rows
    the larger side) within ``SMEM_BUDGET``: up to 62 x 62 in float32 and
    34 x 34 in float64 (a 64 x 32 float32 matrix takes 21 KB)."""
    if dtype not in (torch.float32, torch.float64):
        return False
    rows, cols = max(m, n), min(m, n)
    elem = torch.finfo(dtype).bits // 8
    return (1 <= cols <= MAX_COLS
            and smem_bytes(elem, rows, cols) <= SMEM_BUDGET)


def round_robin(n_p: int):
    """(rounds, pairs, 2) column pairs of the circle method for an even
    ``n_p`` (column 0 fixed, the others rotated one place a round), as the
    kernel's ``round_pair`` and the JAX function's schedule give them."""
    m = n_p - 1
    return torch.tensor(
        [[(0 if k == 0 else 1 + (k - 1 - r) % m, 1 + (n_p - 2 - k - r) % m)
          for k in range(n_p // 2)] for r in range(m)], dtype=torch.int64)


def jacobi_svd_reference(A: torch.Tensor, return_sweeps: bool = False):
    """Plain PyTorch version, batched over the leading dimensions of ``A``
    (..., m, n): the kernel's scaling, pivoted Householder QR, sweeps on
    ``P R^T``, tests, rotations and ordering, in A's dtype.  Returns ``(U,
    s, Vh)`` as ``torch.linalg.svd(A, full_matrices=False)`` does, and the
    sweeps of each matrix (int32, ``MAX_SWEEPS + 1``: not converged) with
    ``return_sweeps``."""
    m, n = A.shape[-2:]
    if m < n:
        U, s, Vh, used = jacobi_svd_reference(A.mT, return_sweeps=True)
        out = (Vh.mT, s, U.mT)
        return out + (used,) if return_sweeps else out
    lead = A.shape[:-2]
    X = A.reshape((-1, m, n))
    b, n_p = X.shape[0], n + (n & 1)
    scale = X.abs().amax(dim=(-2, -1)) if X.numel() else X.new_zeros(b)
    safe_scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    X = X / safe_scale[:, None, None]
    # Householder QR with column pivoting: X P = Q R, the reflectors'
    # vectors kept in X's columns; step j takes the column of largest
    # norm over rows j on (NaN counts as -1, ties to the lowest index)
    rdiag, f = X.new_zeros((b, n)), X.new_zeros((b, n))
    perm = torch.arange(n, device=X.device).expand(b, n).clone()
    rows = torch.arange(b, device=X.device)
    ss = (X * X).sum(1)
    for j in range(n):
        key = torch.where(torch.isnan(ss), torch.full_like(ss, -1.0), ss)
        piv = j + torch.argmax(key[:, j:], dim=-1)
        X[rows, :, j], X[rows, :, piv] = X[rows, :, piv], X[rows, :, j]
        perm[rows, j], perm[rows, piv] = perm[rows, piv], perm[rows, j]
        x = X[:, j:, j]
        norm = torch.sqrt((x * x).sum(-1))
        beta = torch.where(x[:, 0] >= 0, -norm, norm)
        vv = 2 * norm * (norm + x[:, 0].abs())
        x[:, 0] = x[:, 0] - beta
        f[:, j] = torch.where(vv > 0, 2 / vv, torch.zeros_like(vv))
        rdiag[:, j] = beta
        w = (x[:, :, None] * X[:, j:, j + 1:]).sum(1) * f[:, j, None]
        X[:, j:, j + 1:] -= w[:, None, :] * x[:, :, None]
        ss = (X[:, j + 1:, :] ** 2).sum(1)
    R = torch.triu(X[:, :n, :], 1) + torch.diag_embed(rdiag)
    # one-sided Jacobi on P R^T (n_p x n_p, zero-padded; row perm[k] holds
    # R^T's row k), rotations into Z
    W = X.new_zeros((b, n_p, n_p))
    W[:, :n, :n].scatter_(1, perm[:, :, None].expand(b, n, n), R.mT)
    Z = torch.eye(n_p, dtype=X.dtype, device=X.device).expand(
        b, n_p, n_p).clone()
    tol = torch.finfo(X.dtype).eps * math.sqrt(m)
    used = torch.full((b,), MAX_SWEEPS + 1, dtype=torch.int32,
                      device=X.device)
    schedule = round_robin(n_p).to(X.device)
    for sweep in range(MAX_SWEEPS if n else 0):
        rotated = torch.zeros(b, dtype=torch.bool, device=X.device)
        for P, Q in zip(schedule[..., 0], schedule[..., 1]):
            Wp, Wq = W[..., P], W[..., Q]
            al, be = (Wp * Wp).sum(-2), (Wq * Wq).sum(-2)
            ga = (Wp * Wq).sum(-2)
            fail = ga.abs() > tol * al.sqrt() * be.sqrt()
            d = 0.5 * (be - al)
            t = torch.where(d < 0, -ga, ga) / (d.abs() + torch.hypot(d, ga))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = c * t
            c = torch.where(fail, c, torch.ones_like(c))[:, None, :]
            s = torch.where(fail, s, torch.zeros_like(s))[:, None, :]
            W[..., P], W[..., Q] = c * Wp - s * Wq, s * Wp + c * Wq
            Zp, Zq = Z[..., P], Z[..., Q]
            Z[..., P], Z[..., Q] = c * Zp - s * Zq, s * Zp + c * Zq
            rotated |= fail.any(-1)
        used = torch.where(~rotated & (used > MAX_SWEEPS),
                           torch.full_like(used, sweep + 1), used)
        if bool((used <= MAX_SWEEPS).all()):
            break
    # P R^T Z = W diag(s): A = X P P^T = (Q Z) diag(s) W^T
    norms = torch.sqrt((W * W).sum(-2))[:, :n]
    key = torch.where(torch.isnan(norms), torch.full_like(norms, float("inf")),
                      norms)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    s_sorted = torch.gather(norms, 1, order)
    safe = torch.where(s_sorted > 0, s_sorted, torch.ones_like(s_sorted))
    Vh = (torch.gather(W[:, :n, :n], 2, order[:, None, :].expand(b, n, n))
          / safe[:, None, :]).mT
    U = X.new_zeros((b, m, n))
    U[:, :n, :] = torch.gather(Z[:, :n, :n], 2,
                               order[:, None, :].expand(b, n, n))
    for j in reversed(range(n)):
        v = X[:, j:, j]
        w = (v[:, :, None] * U[:, j:, :]).sum(1) * f[:, j, None]
        U[:, j:, :] -= w[:, None, :] * v[:, :, None]
    out = (U.reshape(lead + (m, n)), (s_sorted * safe_scale[:, None])
           .reshape(lead + (n,)), Vh.reshape(lead + (n, n)))
    return out + (used.reshape(lead),) if return_sweeps else out


@functools.cache
def _library():
    """The built kernel library with its C signatures declared (once per
    process)."""
    return cuda_build.library("jacobi_svd", {
        "tt_jacobi_svd": ([I32, PTR, I64, I32, I32, I64, I64, I64]
                          + [PTR] * 5, I32),
        "tt_jacobi_svd_fits": ([I32] * 3, I32),
        "tt_jacobi_svd_smem": ([I32] * 3, I64),
    })


@profiling.spanned("tt.kernel.jacobi_svd")
def jacobi_svd(A: torch.Tensor, return_sweeps: bool = False):
    """``(U, s, Vh)`` of every matrix of ``A`` (..., m, n) that
    ``jacobi_fits``, as ``torch.linalg.svd(A, full_matrices=False)``
    returns them (s descending), in A's dtype; with ``return_sweeps`` also
    the sweeps of each matrix (int32; ``MAX_SWEEPS + 1``: not converged).

    CPU tensors take ``jacobi_svd_reference``.  CUDA tensors launch the
    kernel once for the whole batch (counted as ``launches.jacobi_svd``;
    an empty batch launches nothing), on the current stream, with no sync:
    any strides, a wide matrix read as its transpose."""
    m, n = A.shape[-2:]
    if not jacobi_fits(m, n, A.dtype):
        raise ValueError(f"jacobi_svd: a {m} x {n} {A.dtype} matrix beyond "
                         f"the kernel's fit")
    if A.device.type == "cpu":
        return jacobi_svd_reference(A, return_sweeps)
    if A.device.type != "cuda":
        raise ValueError(f"jacobi_svd: A lies on {A.device}")
    wide = m < n
    X = A.mT if wide else A
    rows, cols = X.shape[-2:]
    lead = X.shape[:-2]
    X = X.reshape((-1, rows, cols))
    b, device = X.shape[0], A.device
    U = torch.empty((b, rows, cols), dtype=A.dtype, device=device)
    s = torch.empty((b, cols), dtype=A.dtype, device=device)
    Vh = torch.empty((b, cols, cols), dtype=A.dtype, device=device)
    used = torch.empty(b, dtype=torch.int32, device=device)
    if b:
        cuda_build.launch(
            _library(), "tt_jacobi_svd", device,
            torch.finfo(A.dtype).bits // 8, X.data_ptr(), b, rows, cols,
            *X.stride(), U.data_ptr(), s.data_ptr(), Vh.data_ptr(),
            used.data_ptr(), what="jacobi_svd")
        profiling.launched("jacobi_svd", X, U, s, Vh)
    U, s, Vh = (U.reshape(lead + (rows, cols)), s.reshape(lead + (cols,)),
                Vh.reshape(lead + (cols, cols)))
    out = (Vh.mT, s, U.mT) if wide else (U, s, Vh)
    return out + (used.reshape(lead),) if return_sweeps else out
