"""Multi-process entry points over ``torch.distributed``.

Counterpart of ``tt_sketch_tpu/dist/multihost.py``.  The JAX package runs
one controller process per host that drives a ``Mesh`` of devices; the port
runs one process per device (SPMD), and a ``Mesh`` is a grid of process
ranks:

- ``initialize_multihost`` joins the process group
  (``init_process_group`` with a ``tcp://`` init method, or the
  ``env://`` defaults when no address is given).  The backend is explicit:
  ``"nccl"`` when the default device is CUDA, ``"gloo"`` on the CPU, or
  the caller's choice; a backend that fails raises and no other is tried.
- ``global_mesh`` lays the world's ranks out in row-major order over named
  axes, as ``np.array(jax.devices()).reshape(axis_sizes)`` lays out
  devices.
- ``make_global`` returns this rank's block of a host array on this
  rank's device: every rank passes the same host array and uploads only
  its own block, where JAX's ``make_global`` returns the global array.

No process group is needed for a mesh of one rank: a single process
sketches alone, as a single-process JAX mesh does.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tt_sketch_torch.config import default_device, resolve_device


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array: an axis name (the dimension is
    cut into equal blocks along it) or None (not cut).  Dimensions past
    the spec's length are not cut."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


P = PartitionSpec


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the global process group.

    Arguments not given are read from ``TT_SKETCH_TORCH_COORDINATOR``
    (``host:port`` of rank 0), ``TT_SKETCH_TORCH_NUM_PROCESSES`` and
    ``TT_SKETCH_TORCH_PROCESS_ID``; with no address at all,
    ``init_process_group`` reads its own ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

    ``backend`` defaults to ``"nccl"`` when the package's default device is
    CUDA and to ``"gloo"`` otherwise.  On CUDA the rank's current device
    becomes ``LOCAL_RANK`` (if set, else the rank) modulo the number of
    cards, so one process per card is the default layout and several
    ranks share one card when there are fewer cards than ranks (gloo only:
    NCCL refuses two ranks on one device).
    """
    address = coordinator_address or os.environ.get(
        "TT_SKETCH_TORCH_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("TT_SKETCH_TORCH_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("TT_SKETCH_TORCH_PROCESS_ID")
    cuda = default_device().type == "cuda"
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if address is not None and "://" not in address:
        address = f"tcp://{address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if cuda:
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = process_id if process_id is not None else _env_int("RANK")
        if local is None:
            raise ValueError(
                "initialize_multihost: the process id is needed to pick "
                "this rank's card")
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=address, **kwargs)


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """Process ranks laid out over named axes.

    ``ranks`` is an integer array of global ranks whose shape gives the
    axis sizes (``mesh.shape[axis]``).  A mesh over a subset of the world
    makes its own process group, which is a collective call over the whole
    world: every process builds every mesh, in the same order, as the JAX
    package asks every process to build the same mesh.  Only the ranks of
    a mesh call the entry points with it.
    """

    def __init__(self, ranks, axis_names: Sequence[str]) -> None:
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(
                f"{ranks.ndim}-d ranks for axes {axis_names}")
        world = process_count()
        flat = ranks.ravel().tolist()
        if sorted(set(flat)) != sorted(flat) or not all(
                0 <= r < world for r in flat):
            raise ValueError(
                f"mesh ranks {flat} are not distinct ranks of a world of "
                f"{world}")
        self.ranks = ranks
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, ranks.shape))
        self.size = int(ranks.size)
        self.group = None
        if dist.is_initialized() and self.size < world:
            self.group = dist.new_group(sorted(flat))

    def __contains__(self, rank: int) -> bool:
        return int(rank) in self.ranks

    def coords(self) -> Dict[str, int]:
        """This process's coordinate on every axis."""
        where = np.argwhere(self.ranks == process_index())
        if len(where) == 0:
            raise ValueError(
                f"rank {process_index()} is not in this mesh of ranks "
                f"{self.ranks.ravel().tolist()}")
        return dict(zip(self.axis_names, (int(c) for c in where[0])))

    def axis_index(self, axis: str) -> int:
        return self.coords()[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def global_mesh(axis_names=("data",), axis_sizes=None) -> Mesh:
    """A mesh over every rank of the world, in row-major order.

    ``axis_sizes=None`` puts every rank on the first axis."""
    world = process_count()
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(axis_names) - 1)
    return Mesh(np.arange(world).reshape(axis_sizes), axis_names)


def make_global(mesh: Mesh, spec, arr, device=None) -> torch.Tensor:
    """This rank's block of the host array ``arr`` (numpy or torch), on
    ``device`` (default: the package default device).

    Dimension ``i`` is cut into equal blocks along the axis ``spec[i]``
    and the block at this rank's coordinate is uploaded; nothing else of
    ``arr`` is copied.  Every rank passes the same array.  A dimension that
    its axis does not divide raises ``ValueError``, as in the JAX
    package."""
    t = torch.as_tensor(arr)
    coords = mesh.coords()
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, parts = t.shape[dim], mesh.shape[axis]
        if n % parts:
            raise ValueError(
                f"dimension {dim} of size {n} is not divisible by the "
                f"{parts} blocks of axis {axis!r}")
        block = n // parts
        t = t.narrow(dim, coords[axis] * block, block)
    return t.to(resolve_device(device)).contiguous()
