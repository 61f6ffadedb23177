"""The staged render pipeline (port of ``raytrace_tpu/pipeline.py``): the
bounce loop taken apart into stages that hand plain tensors to each
other, for users who want to look at or change one stage.

    generate_rays  (scene, pix, samp)             -> RayBatch
    intersect_rays (scene, RayBatch)              -> intersect.Hit
    shade_hits     (scene, RayBatch, Hit, bounce) -> ShadeResult
    assemble_image (radiance, width, height, samples) -> (H, W, 3)

Every stage runs on the device of the scene, in plain PyTorch: the main
path (``renderer.render_wavefront``) fuses them into the trace kernels
because a wavefront that crosses memory between stages is what the
kernels exist to avoid. The JAX shade stage computes every lane and masks
the dead ones; the port's bounce (``trace._bounce``) works on the lanes
that hit, so ``shade_hits`` runs it on the live lanes and scatters the
results back to every lane. Each lane then holds what the JAX stage
gives it: a lane that was dead, or missed, keeps its radiance, its
throughput and its ray; a lane that scattered carries its new throughput
and ray, also when fast_mc's roulette ends it.

``AdaptivePipeline`` renders in batches of samples through
``Renderer.render_linear`` (on the card: the mask and trace kernels),
sizing each batch toward a target time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import renderer as renderer_mod
from . import trace as trace_mod
from .ops import intersect


class RayBatch(NamedTuple):
    origin: torch.Tensor     # (B,3)
    direction: torch.Tensor  # (B,3)
    pix_id: torch.Tensor     # (B,) integer
    samp_id: torch.Tensor    # (B,) integer


class ShadeResult(NamedTuple):
    radiance: torch.Tensor    # (B,3) emitted + weighted direct light
    throughput: torch.Tensor  # (B,3) attenuation * reflection weight
    next_rays: RayBatch       # the scattered continuation rays
    alive: torch.Tensor       # (B,) bool: lanes that scattered on


def generate_rays(scene, pix_id, samp_id, *, width: int, height: int,
                  cfg: Optional[trace_mod.TraceConfig] = None,
                  go_camera: bool = True) -> RayBatch:
    """Stage 1: camera rays with sub-pixel jitter."""
    cfg = cfg or trace_mod.TraceConfig()
    o, d = renderer_mod._lane_rays(scene, pix_id, samp_id, width=width,
                                   height=height, cfg=cfg,
                                   go_camera=go_camera)
    return RayBatch(o, d, pix_id, samp_id)


def intersect_rays(scene, rays: RayBatch, t_min: float = 1e-3):
    """Stage 2: the closest hit over the whole scene, brute force as in
    the JAX package."""
    return intersect.closest_hit(scene.geometry, rays.origin,
                                 rays.direction, t_min=t_min)


def shade_hits(scene, rays: RayBatch, hit, bounce: int = 0, *,
               cfg: Optional[trace_mod.TraceConfig] = None,
               throughput=None, radiance=None,
               alive=None) -> ShadeResult:
    """Stage 3: one shading evaluation, emitted + weighted direct light
    and the scattered rays of the next round.

    ``throughput``/``radiance``/``alive`` carry the wavefront between
    rounds (None: a fresh bounce-0 wavefront). ``hit`` is the intersect
    stage's output for ``rays`` and is not computed again: a broken
    intersect stage breaks the shading."""
    cfg = cfg or trace_mod.TraceConfig()
    o, d = rays.origin, rays.direction
    tp = torch.ones_like(o) if throughput is None else throughput
    rad = (torch.zeros_like(o) if radiance is None else radiance).clone()
    live = (torch.arange(o.shape[0], device=o.device) if alive is None
            else alive.nonzero()[:, 0])
    sub = intersect.Hit(*(f[live] for f in hit))
    keep, emitted, lit, scat, point, new_d, new_tp = trace_mod._bounce(
        scene, rays.pix_id[live], rays.samp_id[live], cfg, bounce, o[live],
        d[live], tp[live], hit=sub)
    lanes = live[keep]
    # two adds in the order of the JAX stage: (R + emitted) + direct
    rad[lanes] = rad[lanes] + emitted
    rad[lanes] = rad[lanes] + lit
    on = scat.nonzero()[:, 0]
    lanes = lanes[on]
    go, tp_on = None, new_tp[on]
    if cfg.recursive_reflections:
        go, tp_on = trace_mod.fast_mc(cfg, bounce, rays.pix_id[lanes],
                                      rays.samp_id[lanes], tp_on)
    tp_out, o_out, d_out = tp.clone(), o.clone(), d.clone()
    tp_out[lanes] = tp_on
    o_out[lanes] = point[on]
    d_out[lanes] = new_d[on]
    alive_out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if cfg.recursive_reflections:
        alive_out[lanes if go is None else lanes[go]] = True
    return ShadeResult(
        radiance=rad, throughput=tp_out,
        next_rays=RayBatch(o_out, d_out, rays.pix_id, rays.samp_id),
        alive=alive_out)


def assemble_image(radiance, *, width: int, height: int, samples: int):
    """Stage 4: the per-pixel mean over its samples (pixel-major lanes)."""
    return radiance.reshape(width * height, samples, 3).mean(dim=1).reshape(
        height, width, 3)


def run_pipeline(scene, *, width: int, height: int, samples: int,
                 cfg: Optional[trace_mod.TraceConfig] = None,
                 go_camera: bool = True) -> torch.Tensor:
    """The staged pipeline to a whole (H, W, 3) linear image on the
    scene's device: generate once, then up to ``cfg.max_depth`` rounds of
    intersect_rays and shade_hits carrying throughput, radiance and alive,
    then assemble. It equals the eager engine (``trace.trace``) at the
    same settings; every stage crosses memory, so it is slower than the
    fused kernels by design."""
    cfg = cfg or trace_mod.TraceConfig()
    pix, samp = renderer_mod._lane_ids(
        torch.arange(width * height, device=scene.device), samples)
    cur = generate_rays(scene, pix, samp, width=width, height=height,
                        cfg=cfg, go_camera=go_camera)
    throughput = radiance = alive = None
    for bounce in range(cfg.max_depth):
        hit = intersect_rays(scene, cur)
        sh = shade_hits(scene, cur, hit, bounce=bounce, cfg=cfg,
                        throughput=throughput, radiance=radiance,
                        alive=alive)
        throughput, radiance, alive = sh.throughput, sh.radiance, sh.alive
        cur = sh.next_rays
        if not bool(alive.any()):  # a host read: fine for this driver
            break
    return assemble_image(radiance, width=width, height=height,
                          samples=samples)


@dataclasses.dataclass
class AdaptivePipeline:
    """Feedback-sized batches of samples: each batch is timed and the next
    is scaled toward ``target_seconds`` (within min_batch..max_batch), for
    progressive previews that want a steady frame pace."""

    target_seconds: float = 0.5
    min_batch: int = 1
    max_batch: int = 64
    batch: int = 4

    def render(self, renderer, scene, width: int, height: int,
               total_samples: int) -> np.ndarray:
        """(H, W, 3) float32 mean linear radiance over ``total_samples``;
        batch k runs at the seed ``renderer.seed`` + the samples done, as
        ``parallel.render_with_checkpoints`` does."""
        from .parallel import Accumulator
        acc = Accumulator.zeros(width, height, renderer.seed)
        saved = renderer.samples, renderer.seed
        try:
            while acc.samples_done < total_samples:
                n = min(self.batch, total_samples - acc.samples_done)
                renderer.samples = n
                renderer.seed = saved[1] + acc.samples_done
                t0 = time.perf_counter()
                band = renderer.render_linear(scene, width, height)
                dt = max(time.perf_counter() - t0, 1e-6)
                acc.add(band, n)
                self.batch = int(np.clip(round(self.batch
                                               * self.target_seconds / dt),
                                         self.min_batch, self.max_batch))
        finally:
            renderer.samples, renderer.seed = saved
        return acc.mean()
