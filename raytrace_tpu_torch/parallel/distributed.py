"""Multi-process orchestration: the working form of the reference's HTTP
distributed renderer, over ``torch.distributed``.

Port of ``raytrace_tpu/parallel/distributed.py``. The reference fanned
RenderChunk JSON out over HTTP POST (distributed_renderer.go:76-106),
picked the least-loaded node (:108-123), and its server returned empty
pixels after a 100 ms sleep (:258-283). Here:

* node discovery and join -> ``initialize()``:
  ``torch.distributed.init_process_group`` over a ``tcp://`` coordinator
  address (or torchrun's environment), NCCL where each process has a card
  of its own, gloo otherwise (processes sharing a card, or the CPU);
* RenderChunk POST -> the sharded renders (``parallel/shard.py``), the
  chunk being a process's px shards, assembled by an ``all_reduce``;
* /status polling -> ``NodeStatus.collect()`` and ``heartbeat()``, an
  ``all_reduce`` of each process's one-hot that proves the group alive;
* LoadBalancer -> not needed: a static partition has no imbalance to
  balance;
* failedJobs -> ``rerender_missing_rows``: every pixel is a pure function
  of its (pixel, sample) counters, so any process can render a lost
  band again, identically.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import _device
from .. import renderer as renderer_mod
from . import mesh as mesh_mod
from . import shard as shard_mod

# torchrun's environment: initialize() without arguments joins through it.
_TORCHRUN_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def _pick_device(local_rank: int, local_world: int, device):
    """(device, backend) of a process: ``device`` if given (gloo on the
    CPU), else a CUDA device: cuda:local_rank and NCCL where the host's
    processes have a card each, else the cards shared round robin and
    gloo (NCCL puts no two processes on one card)."""
    if device is not None:
        dev = mesh_mod._as_device(device)
        if dev.type != "cuda":
            return dev, "gloo"
    else:
        _device.resolve(None)  # raises when there is no GPU
    n = torch.cuda.device_count()
    if local_world <= n:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", local_rank % n), "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None):
    """Join (or form) a group of ``num_processes`` processes.

    ``coordinator_address`` is "host:port" (or a "tcp://" URL) of process
    0, which listens there. Without any argument this is a no-op unless
    torchrun's environment (MASTER_ADDR, WORLD_SIZE, RANK) is set; then
    it joins through it, on cuda:LOCAL_RANK. ``device``: this process's
    device (default CUDA: see ``_pick_device``; "cpu" runs the group on
    gloo and the plain path). The local process count is
    LOCAL_WORLD_SIZE, else ``num_processes`` (one host). Returns the
    device, which ``make_mesh`` then takes by default, or None for the
    no-op."""
    dist = torch.distributed
    given = (coordinator_address, num_processes, process_id)
    from_env = all(a is None for a in given)
    if from_env and not all(os.environ.get(k) for k in _TORCHRUN_ENV):
        return None
    if from_env:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = "env://"
    else:
        if any(a is None for a in given):
            raise ValueError("initialize needs coordinator_address, "
                             "num_processes and process_id together")
        world, rank = int(num_processes), int(process_id)
        init_method = (coordinator_address
                       if coordinator_address.startswith("tcp://")
                       else f"tcp://{coordinator_address}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev, backend = _pick_device(local_rank, local_world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    mesh_mod._GROUP_DEVICE["device"] = dev
    return dev


def shutdown() -> None:
    """Leave the group (``destroy_process_group``), if one was joined."""
    if mesh_mod.in_group():
        torch.distributed.destroy_process_group()
    mesh_mod._GROUP_DEVICE["device"] = None


@dataclasses.dataclass
class NodeStatus:
    """The working /status payload (vs. distributed_renderer.go:285-302)."""

    process_id: int
    process_count: int
    local_devices: int
    global_devices: int
    platform: str
    available: bool
    timestamp: float

    @classmethod
    def collect(cls) -> "NodeStatus":
        """From the group's rank and size and this process's devices
        (``mesh.local_devices()``; none where there is no GPU and no group
        device: not available)."""
        n_world, rank = mesh_mod.world()
        try:
            devs = mesh_mod.local_devices()
        except RuntimeError:  # no GPU, no group device
            devs = []
        return cls(process_id=rank, process_count=n_world,
                   local_devices=len(devs),
                   global_devices=len(devs) * n_world,
                   platform=devs[0].type if devs else "none",
                   available=bool(devs), timestamp=time.time())


def heartbeat() -> np.ndarray:
    """Prove the group alive: an ``all_reduce`` of this process's one-hot.

    Returns the participation vector, every entry 1 when every process
    took part (a process that did not leaves a 0, or the collective
    raises: either way the failure is seen, unlike the reference's
    status that always reported healthy)."""
    n_world, rank = mesh_mod.world()
    onehot = np.zeros((n_world,), np.float32)
    onehot[rank] = 1.0
    if not mesh_mod.in_group():
        return onehot
    t = torch.from_numpy(onehot).to(mesh_mod.group_device() or "cpu")
    torch.distributed.all_reduce(t)
    return t.cpu().numpy()


def rerender_missing_rows(renderer, scene, partial_img: np.ndarray,
                          missing_rows, width: int, height: int,
                          cfg=None) -> np.ndarray:
    """Elastic recovery: render again only the rows a failed worker lost.

    The working form of the reference's failedJobs counter
    (distributed_renderer.go:93-104, which counted failures and did
    nothing): a pixel's samples are a pure function of (pixel, sample), so
    any process renders a row again identically. The missing rows are
    grouped into contiguous bands, each rendered by ``render_band`` on the
    renderer's device (``renderer.samples``, ``renderer.go_camera``) and
    spliced in. Returns the completed image."""
    out = np.array(partial_img, copy=True)
    bands = []
    for r in sorted(set(int(r) for r in missing_rows)):
        if bands and r == bands[-1][1]:
            bands[-1][1] = r + 1
        else:
            bands.append([r, r + 1])
    if cfg is None:
        cfg = renderer.trace_config()
    scene = scene.to(renderer.device)
    for y0, y1 in bands:
        band = renderer_mod.render_band(
            scene, y0, width=width, height=height, band_h=y1 - y0,
            samples=renderer.samples, cfg=cfg, go_camera=renderer.go_camera)
        out[y0:y1] = band.cpu().numpy()
    return out


class DistributedRenderer:
    """The multi-process render driver (distributed_renderer.go:14-27).

    In one process it is the sharded path over the mesh; under a group
    every process runs the same calls and receives the whole image."""

    def __init__(self, mesh=None, sp: int = 1):
        self.mesh = mesh or mesh_mod.make_mesh(sp=sp)
        self.completed_jobs = 0
        self.failed_jobs = 0

    def render_linear(self, scene, width: int, height: int, *, samples: int,
                      cfg, go_camera: bool = True) -> np.ndarray:
        try:
            out = shard_mod.render_linear_sharded(
                scene, width, height, samples=samples, cfg=cfg,
                mesh=self.mesh, go_camera=go_camera)
        except Exception:
            self.failed_jobs += 1
            raise
        self.completed_jobs += 1
        return out

    def get_stats(self) -> dict:
        """Parity with GetStats (distributed_renderer.go:198-217)."""
        n_world, _ = mesh_mod.world()
        total = self.completed_jobs + self.failed_jobs
        return {
            "total_nodes": n_world,
            "available_nodes": n_world,
            "completed_jobs": self.completed_jobs,
            "failed_jobs": self.failed_jobs,
            "success_rate": (self.completed_jobs / total) if total else 1.0,
            "devices": self.mesh.size,
        }
