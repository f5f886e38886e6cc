"""Plain reference of the dense slab stream: the TT-DRM cores from a seed,
the STTA sketch of a tensor streamed in mode-0 slabs, and its recovery.

The sketch is taken straight from its definition, slab by slab: with the
left DRM's prefix matrices ``Y_k`` (rows: the multi-indices of modes
``0..k``) and the right DRM's suffix matrices ``Z_k`` (rows: modes
``k+1..d-1``),

    Psi_k[a, i, b] = sum Y_{k-1}[p, a] X[p, i, s] Z_k[s, b],
    Omega_k        = Y_k^T X^{<k>} Z_k,

summed over the slabs (Psi_0's rows are each slab's own).  Recovery is
``C_k = Psi_k pinv(Omega_k)`` with singular values below float32's
``eps * max(m, n)`` of the largest dropped, as the configuration's float32
calls for.  ``precision`` is ``float64`` (the reference) or ``tf32`` (the
control: every product's operands rounded to TF32, sums in float32).
Imports only torch.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ttbench.reference.lowp import compute_dtype, lower


def drm_cores(shape: Sequence[int], left_rank: int, right_rank: int,
              seed: int, device) -> Tuple[List[torch.Tensor],
                                          List[torch.Tensor]]:
    """Norm-preserving random TT-DRM cores, float32, drawn on ``device``
    from ``seed``: the left DRM's cores over ``shape`` and the right DRM's
    over the reversed shape, each ``(r1, n, r2)`` scaled by ``1/sqrt(r1)``
    (the last core of each is not needed and not drawn)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    d = len(shape)

    def chain(dims, rank):
        cores, r1 = [], 1
        for n in dims[: d - 1]:
            c = torch.randn((r1, int(n), rank), generator=gen, device=device,
                            dtype=torch.float32)
            cores.append(c / math.sqrt(r1))
            r1 = rank
        return cores

    return chain(list(shape), left_rank), chain(list(shape)[::-1], right_rank)


def _prefix(cores, k: int, rows: slice, dt, precision):
    """Y_k over the modes 0..k, mode 0 cut to ``rows``: (prod, r)."""
    y = lower(cores[0][0, rows, :], precision)
    for j in range(1, k + 1):
        c = lower(cores[j], precision)
        y = lower(y, precision)
        y = (y @ c.reshape(c.shape[0], -1).to(dt)).reshape(-1, c.shape[2])
    return y


def _suffix(right_cores, shape, k: int, dt, precision):
    """Z_k over the modes k+1..d-1, rows in C order: (prod, rho)."""
    d = len(shape)
    z = lower(right_cores[0][0], precision)  # (n_{d-1}, rho)
    for j in range(1, d - 1 - k):
        c = lower(right_cores[j], precision)  # (rho, n_{d-1-j}, rho)
        z = lower(z, precision)
        # rows: (i_{d-1-j}, then the previous suffix's rows)
        z = torch.einsum("ta,anb->ntb", z, c.to(z.dtype))
        z = z.reshape(-1, c.shape[2])
    return z


def sketch(slab, n_slabs: int, shape: Sequence[int], left_cores,
           right_cores, precision: str = "float64"):
    """Psi cores and Omega matrices of the stream whose slab ``i`` is
    ``slab(i)`` (any view of ``(n0 / n_slabs, n1, ..., n_{d-1})``)."""
    d = len(shape)
    dt = compute_dtype(precision)
    s0 = int(shape[0]) // n_slabs
    zs = [_suffix(right_cores, shape, k, dt, precision) for k in range(d - 1)]
    r = [int(c.shape[2]) for c in left_cores]
    rho = [int(z.shape[1]) for z in zs]
    dev = zs[0].device
    psi0_rows = []
    psis = [torch.zeros((r[k - 1], int(shape[k]), rho[k] if k < d - 1 else 1),
                        dtype=dt, device=dev) for k in range(1, d)]
    omegas = [torch.zeros((r[k], rho[k]), dtype=dt, device=dev)
              for k in range(d - 1)]
    for i in range(n_slabs):
        x = lower(slab(i).reshape(s0, -1), precision)
        psi0_rows.append(x @ zs[0])
        for k in range(1, d):
            rows = s0
            for n in shape[1:k]:
                rows *= int(n)
            y = lower(_prefix(left_cores, k - 1, slice(i * s0, (i + 1) * s0),
                              dt, precision), precision)
            w = lower(y.T @ x.reshape(rows, -1), precision)  # (r, n_k * rest)
            omegas[k - 1] += w.reshape(r[k - 1], -1) @ zs[k - 1]
            if k < d - 1:
                wk = w.reshape(r[k - 1] * int(shape[k]), -1)
                psis[k - 1] += (wk @ zs[k]).reshape(psis[k - 1].shape)
            else:
                psis[k - 1] += w.reshape(psis[k - 1].shape)
        del x
    psi0 = torch.cat(psi0_rows).reshape(1, int(shape[0]), rho[0])
    return [psi0] + psis, omegas


def recover(psis, omegas, precision: str = "float64"):
    """TT cores ``C_k = Psi_k pinv(Omega_k)``, the last core ``Psi_{d-1}``."""
    return [right_pinv(p, o, precision) for p, o in zip(psis[:-1], omegas)
            ] + [psis[-1]]


def right_pinv(psi: torch.Tensor, omega: torch.Tensor, precision: str):
    """``psi (r1, n, r2) @ pinv(omega)``, cutting singular values below
    float32's ``eps * max(omega.shape)`` of the largest."""
    dt = compute_dtype(precision)
    o = lower(omega, precision).to(dt if dt == torch.float64
                                   else torch.float32)
    rtol = torch.finfo(torch.float32).eps * max(o.shape)
    pinv = torch.linalg.pinv(o, rtol=rtol)
    r1, n, r2 = psi.shape
    out = lower(psi.reshape(r1 * n, r2), precision).to(pinv.dtype) @ pinv
    return out.reshape(r1, n, omega.shape[0])
