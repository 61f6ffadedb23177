"""The device mesh of the port: a (px, sp) grid of shard coordinates.

Port of ``raytrace_tpu/parallel/mesh.py``. The reference's tile pool
(32x32-pixel tiles over a goroutine channel, renderer.go:76-99,398-436)
becomes a static partition of the pixel axis over ``px``; its work
stealing (worker_pool.go:59-64,168-184) is not needed under a static
partition, and load balance comes from sharding the sample axis over
``sp``; its HTTP fan-out (distributed_renderer.go:76-106,153-196) becomes
``torch.distributed`` collectives across processes
(``parallel/distributed.py``).

Axes:
  ``px``  pixel sharding: each coordinate owns a contiguous block of
          pixels (or, in ``render_wavefront_sharded``, of rows);
  ``sp``  sample sharding: the per-pixel partial sums of a px shard's
          coordinates are added over this axis.

A coordinate is a logical shard, not a device: the same device may back
several coordinates (``make_mesh(["cuda:0"] * 4)``, ``["cpu"] * 8``), and
its shards then run one after the other on it. (A departure from the JAX
package, whose mesh holds distinct devices: its CPU tests make 8 virtual
devices, which PyTorch does not have.) Within a process every coordinate
runs; under an initialised ``torch.distributed`` group each process
passes its own local devices, the mesh holds world size times as many
coordinates, and coordinate c belongs to rank c // (local devices): a
process runs only its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import _device

AXES = ("px", "sp")

# The device that parallel.distributed.initialize gave this process, or
# None: the default device of make_mesh under a process group (the group
# itself is process-wide state, and so is its device).
_GROUP_DEVICE = {"device": None}


def in_group() -> bool:
    """Whether a ``torch.distributed`` process group is initialised."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def world() -> tuple:
    """(world size, rank) of the initialised process group, else (1, 0)."""
    if in_group():
        dist = torch.distributed
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def group_device() -> Optional[torch.device]:
    """This process's device under a process group (``initialize``)."""
    return _GROUP_DEVICE["device"] if in_group() else None


def local_devices() -> list:
    """The default devices of this process: its group device under a
    process group, else every local CUDA device. Raises without a GPU, as
    ``_device.resolve`` does."""
    dev = group_device()
    if dev is not None:
        return [dev]
    first = _device.resolve(None)  # raises when there is no GPU
    return [first] + [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())
                      if i != first.index]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (px, sp) grid of coordinates: ``devices[i, j]`` is the device that
    runs coordinate (i, j) on the process that owns it, ``ranks[i, j]``
    that process's rank (0 without a process group)."""

    devices: np.ndarray   # (px, sp) object array of torch.device
    ranks: np.ndarray     # (px, sp) int
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict:
        return {n: int(k) for n, k in zip(self.axis_names,
                                          self.devices.shape)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def multi_process(self) -> bool:
        """Whether results are assembled by collectives: under a process
        group (of any size, one process too), where every process takes
        part in them, those that own no coordinate too."""
        return in_group()

    def is_local(self, i: int, j: int) -> bool:
        """Whether this process runs coordinate (i, j)."""
        return int(self.ranks[i, j]) == world()[1]

    def local_coords(self) -> list:
        """This process's coordinates (i, j), in row-major order."""
        px, sp = self.devices.shape
        return [(i, j) for i in range(px) for j in range(sp)
                if self.is_local(i, j)]

    @property
    def home(self) -> torch.device:
        """Where this process gathers results: the device of its first
        coordinate (its group device where it owns none)."""
        coords = self.local_coords()
        if coords:
            return self.devices[coords[0]]
        return group_device() or self.devices.flat[0]


def _as_device(d) -> torch.device:
    """A mesh device: a CUDA device gets its index (so that equal devices
    compare equal); a CUDA device without a GPU raises."""
    d = torch.device(d)
    return _device.resolve(d) if d.type == "cuda" else d


def make_mesh(devices: Optional[Sequence] = None, px: Optional[int] = None,
              sp: int = 1, axis_names=AXES) -> Mesh:
    """A (px, sp) mesh over ``devices`` (default: ``local_devices()``, which
    raises without a GPU); under a process group, over every process's
    devices, this process passing its own.

    ``px * sp`` must equal the coordinate count (the devices given, times
    the world size); by default every coordinate goes to the pixel axis
    (the reference's live tile parallelism)."""
    local = [_as_device(d) for d in (local_devices() if devices is None
                                     else devices)]
    if not local:
        raise ValueError("a mesh needs at least one device")
    n_world, _ = world()
    n = len(local) * n_world
    if px is None:
        if n % sp != 0:
            raise ValueError(f"device count {n} not divisible by sp={sp}")
        px = n // sp
    if px * sp != n:
        raise ValueError(f"px*sp = {px}*{sp} != {n} devices")
    devs = np.empty(n, dtype=object)
    for c in range(n):
        devs[c] = local[c % len(local)]
    ranks = np.arange(n) // len(local)
    return Mesh(devs.reshape(px, sp), ranks.reshape(px, sp),
                tuple(axis_names))


def single_device_mesh(device=None) -> Mesh:
    """The degenerate 1x1 mesh: the same code path, no collectives within
    a process. ``device``: default the first of ``local_devices()``. Under
    a process group rank 0 owns the coordinate (the JAX package's global
    device 0) and the others receive its result."""
    dev = local_devices()[0] if device is None else _as_device(device)
    return Mesh(np.array([[dev]], dtype=object), np.zeros((1, 1), int))
