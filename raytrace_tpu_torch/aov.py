"""AOV (arbitrary output variable) feature buffers for compositing and
denoising.

Port of ``raytrace_tpu/aov.py``. One deterministic center ray per pixel
through ``intersect.closest_hit`` (the scene BVH's walk where the scene
has one) gives the standard feature set - depth, world position, shading
normal, material albedo and id, hit mask, front face - the inputs of the
feature-guided denoiser (``denoising.denoise``) next to a noisy radiance
pass such as an adaptive render's. Center rays (pixel centers, no
jitter) keep every buffer free of noise, through the camera model of the
beauty pass. Torch operations on the device: the JAX package computes
these outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _device
from . import atmosphere as atmo_mod
from . import trace as trace_mod
from ._f32 import sqrt as _sqrt
from .ops import intersect

__all__ = ["render_aovs"]


def render_aovs(scene, *, width: int, height: int,
                cfg: Optional[trace_mod.TraceConfig] = None,
                go_camera: bool = True, as_numpy: bool = True,
                device=None) -> Dict:
    """Feature buffers from one center ray per pixel.

    Returns {"depth" (H,W) world units (t * |d|, the directions being
    unnormalised; BIG on a miss), "hit" (H,W) bool, "position", "normal",
    "albedo" (H,W,3) (zeros on a miss; the albedo is the material's
    ``eff_albedo``: dielectrics white, lights black), "mat_id" (H,W) int32
    (-1 on a miss), "front_face" (H,W) bool}: numpy, or tensors on the
    device with ``as_numpy=False``. The rays go in chunks of
    ``atmosphere.center_chunk``, which changes no result.

    Runs on ``device`` (default CUDA; raises without a GPU unless
    ``device="cpu"``). ``cfg`` is accepted for the symmetry of the render
    entry points; the buffers ignore the sampling settings.
    """
    del cfg
    dev = _device.resolve(device)
    scene = scene.to(dev)
    o, d = atmo_mod.center_rays(scene, width, height, go_camera)
    step = atmo_mod.center_chunk(scene)
    parts = []
    for i in range(0, o.shape[0], step):
        oc, dc = o[i:i + step], d[i:i + step]
        hit = intersect.closest_hit(scene.geometry, oc, dc, t_min=1e-3,
                                    accel=scene.accel)
        norm = _sqrt(dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1]
                     + dc[:, 2] * dc[:, 2])
        h3 = hit.hit[:, None]
        albedo = scene.materials.row(hit.mat_id)["eff_albedo"]
        parts.append({
            "depth": torch.where(hit.hit, hit.t * norm,
                                 torch.full_like(norm, intersect.BIG)),
            "hit": hit.hit,
            "position": torch.where(h3, hit.point, 0.0),
            "normal": torch.where(h3, hit.normal, 0.0),
            "albedo": torch.where(h3, albedo, 0.0),
            "mat_id": torch.where(hit.hit, hit.mat_id, -1).to(torch.int32),
            "front_face": hit.front_face & hit.hit,
        })
    out = {k: torch.cat([p[k] for p in parts]).reshape(
        height, width, *parts[0][k].shape[1:]) for k in parts[0]}
    if as_numpy:
        out = {k: v.cpu().numpy() for k, v in out.items()}
    return out
