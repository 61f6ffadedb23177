"""One process of a multi-process render group (the port of
``tools/dist_worker.py``): the working form of what the reference's
RemoteRenderServer only stubbed (distributed_renderer.go:219-302).

    python -m raytrace_tpu_torch.tools.dist_worker <coordinator host:port> \\
        <num_procs> <proc_id> <out_npz> [--device cpu] [--scene PATH] \\
        [--size 32x24] [--spp 2] [--depth 3] [--wavefront WxH,SPP,DEPTH]

The worker joins the group (``parallel.initialize``: NCCL where each
process has a card of its own, gloo where processes share one or with
``--device cpu``), collects its ``NodeStatus``, proves the group alive
with ``heartbeat()``, renders the scene (``--scene``, a scene JSON, or a
two-sphere scene) through ``DistributedRenderer.render_linear`` over the
group's px mesh (one coordinate a process, 2 soft-shadow rays), and takes
one sharded train step (``diff.make_train_step(mesh=)``, SGD at lr 1e-2
on the light intensities, target black). With ``--wavefront`` it also
renders the sharded wavefront (``render_wavefront_sharded``, the kernels
on the card, 16 soft-shadow rays) at that size. Process 0 writes what it
received to <out_npz>; every process exits non-zero if its own checks
fail.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

from .. import diff
from .. import scene as scene_mod
from .. import trace as trace_mod
from ..parallel import distributed as dist_mod
from ..parallel import mesh as mesh_mod
from ..parallel import shard as shard_mod

SCENE_DICT = {
    "camera": {"position": [0, 0, 8], "lookAt": [0, 0, 0],
               "up": [0, 1, 0], "fov": 45, "aspectRatio": 1.333},
    "objects": [
        {"type": "sphere", "position": [0, 0, 0], "radius": 1.5,
         "material": {"type": "lambertian", "albedo": [0.8, 0.3, 0.3]}},
        {"type": "sphere", "position": [2, 0.5, -1], "radius": 0.8,
         "material": {"type": "metal", "albedo": [0.9, 0.9, 0.9],
                      "roughness": 0.1, "metallic": 0.9}},
    ],
    "lights": [{"type": "point", "position": [5, 5, 5],
                "color": [1, 1, 1], "intensity": 2.0}],
}


def _size(text: str) -> tuple:
    w, h = text.lower().split("x")
    return int(w), int(h)


def _wavefront(text: str) -> tuple:
    size, spp, depth = text.split(",")
    return _size(size) + (int(spp), int(depth))


def train_step(scene, *, width: int, height: int, samples: int, cfg,
               mesh=None):
    """One step of the worker's train step: (loss, the light intensities
    after it) as numpy."""
    state, step = diff.make_train_step(
        scene, np.zeros((height, width, 3), np.float32), width=width,
        height=height, samples=samples, cfg=cfg, mesh=mesh,
        optimizer=functools.partial(torch.optim.SGD, lr=1e-2),
        trainable={"lights.intensity"})
    state, loss = step(state)
    return (np.float32(loss.cpu()),
            state.params["lights"]["intensity"].detach().cpu().numpy())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coordinator")
    ap.add_argument("num_procs", type=int)
    ap.add_argument("proc_id", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default=None)
    ap.add_argument("--scene", default=None)
    ap.add_argument("--size", type=_size, default=(32, 24))
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--wavefront", type=_wavefront, default=None)
    a = ap.parse_args(argv)

    dev = dist_mod.initialize(a.coordinator, a.num_procs, a.proc_id,
                              device=a.device)
    try:
        status = dist_mod.NodeStatus.collect()
        hb = dist_mod.heartbeat()
        if a.scene:
            with open(a.scene) as f:
                data = json.load(f)
        else:
            data = SCENE_DICT
        scene = scene_mod.from_dict(data, device=dev)[0]
        width, height = a.size
        cfg = trace_mod.TraceConfig(max_depth=a.depth, shadow_samples=2)
        dr = dist_mod.DistributedRenderer(mesh=mesh_mod.make_mesh(sp=1))
        img = dr.render_linear(scene, width, height, samples=a.spp, cfg=cfg)
        loss, intensity = train_step(scene, width=width, height=height,
                                     samples=a.spp, cfg=cfg, mesh=dr.mesh)
        out = dict(img=img, hb=hb, process_count=status.process_count,
                   global_devices=status.global_devices,
                   platform=status.platform, loss=loss,
                   intensity=intensity, stats=json.dumps(dr.get_stats()))
        if a.wavefront:
            w, h, spp, depth = a.wavefront
            wcfg = trace_mod.TraceConfig(max_depth=depth, shadow_samples=16)
            wf, ov = shard_mod.render_wavefront_sharded(
                scene, width=w, height=h, samples=spp, cfg=wcfg,
                mesh=dr.mesh)
            out.update(wavefront=wf.cpu().numpy(), overflow=int(ov))
        if a.proc_id == 0:
            np.savez(a.out, **out)
        # every process checks what it received, so a failure in any fails
        # its exit code
        if status.process_count != a.num_procs or not status.available:
            raise RuntimeError(f"bad node status {status}")
        if not np.array_equal(hb, np.ones(a.num_procs, np.float32)):
            raise RuntimeError(f"heartbeat {hb}: a process is missing")
        if not (np.isfinite(img).all() and img.max() > 0):
            raise RuntimeError("the gathered image is black or not finite")
        if a.wavefront and out["overflow"] != 0:
            raise RuntimeError(f"wavefront overflow {out['overflow']}")
    finally:
        dist_mod.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
