"""A pool of dense float32 slabs made on the first card from a random TT
of rank ``data_rank`` (``torch.Generator`` on the device, one product a
slab); slab ``i`` of a stream is ``pool[i mod pool_slabs]``, so the
streamed tensor is itself a TT of rank at most ``data_rank``."""
from __future__ import annotations

import math

import torch


def make(config: dict, seed: int, devices, root) -> dict:
    return {"raw": {"pool": _tt_pool(config, seed, devices[0])},
            "program": {}}


def _tt_pool(config: dict, seed: int, device):
    shape = [int(n) for n in config["shape"]]
    s0 = shape[0] // int(config["n_slabs"])
    p, r = int(config["pool_slabs"]), int(config["data_rank"])
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 0x9E3779B1 + 0x5EED) % (1 << 63))
    f32 = torch.float32
    dims = [p * s0] + shape[1:]
    ranks = [1] + [r] * (len(shape) - 1) + [1]
    cores = [torch.randn((ranks[k], n, ranks[k + 1]), generator=gen,
                         device=device, dtype=f32) / math.sqrt(ranks[k])
             for k, n in enumerate(dims)]
    # the modes after the pivot contracted once: (r, prod(shape[2:]))
    right = cores[-1].reshape(r, -1)
    for c in cores[-2:1:-1]:
        right = (c.reshape(-1, r) @ right).reshape(r, -1)
    pool = []
    for i in range(p):
        left = cores[0][0, i * s0:(i + 1) * s0, :]  # (s0, r)
        left = (left @ cores[1].reshape(r, -1)).reshape(-1, r)
        pool.append((left @ right).contiguous())  # (s0 * n1, rest)
    return pool
