"""Render pipeline: scene -> compacted wavefront -> image.

Port of the main path of ``raytrace_tpu/renderer.py``. ``render_wavefront``
is what ``Renderer.render`` runs:

1. the mask (``megakernel.pixel_mask``): a conservative per-pixel hit
   mask from one center ray per pixel against cone-inflated primitives,
   K2 (brute force) or K6 (a walk over the scene BVH's inflated slabs);
2. pixel-granular compaction: a cumsum and a scatter of hit pixel ids;
3. camera rays for the hit pixels' lanes (pcg4d jitter, ``_lane_rays``);
4. the trace (``megakernel.trace``), by the scene's kernel mode
   (``megakernel._kernel_mode``): K1 (up to 96 primitives, 48 in a
   smooth-shaded scene), K3+K4 (97-4096 primitives with a scene BVH) or
   K7 (past the unroll limit without a BVH), the whole bounce loop per
   lane;
5. a per-pixel segment-add of the samples back into the image.

A lane that misses everything is exactly black, so only hit pixels are
traced, and since every draw is keyed by (pixel, sample) the result equals
the dense path's (``render_band``/``lane_radiance``, which run the plain
engine over every lane and serve as the reference).

The host reads one number, the hit-pixel count, to size the trace. The
JAX package's speculative capacity cache (``_KPAD_CACHE``) and its
mid-trace survivor re-compaction (``split``, on by default only for
stream-mode scenes there) are not in the port yet (ROADMAP Queue 1 items 5
and 6).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from . import _device
from . import camera as cam_mod
from . import rng
from . import trace as trace_mod
from .ops import megakernel, tonemap
from .utils import image as image_util


@dataclasses.dataclass
class BenchmarkData:
    """Parity with the reference's benchmark JSON (same keys)."""

    scene_name: str = ""
    resolution: str = ""
    render_time_seconds: float = 0.0
    samples: int = 0
    max_depth: int = 0
    num_workers: int = 0
    objects: int = 0
    lights: int = 0
    timestamp: str = ""
    features: tuple = (
        "Improved metallic reflections with Fresnel effect",
        "Shiny materials with configurable roughness and specular",
        "Enhanced light source reflections",
        "Better specular highlights for metallic surfaces",
    )

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["features"] = list(self.features)
        return json.dumps(d, indent=2)


def _lane_ids(pixels: torch.Tensor, samples: int):
    """(pixel, sample) ids of `samples` lanes per pixel, pixel-major."""
    pix = torch.repeat_interleave(pixels.to(torch.int64), samples)
    samp = torch.arange(samples, device=pixels.device).repeat(
        pixels.shape[0])
    return pix, samp


def _lane_rays(scene, pix_id, samp_id, *, width: int, height: int,
               cfg: trace_mod.TraceConfig, go_camera: bool):
    """Camera rays of (pixel, sample) lanes: sub-pixel jitter from the
    counter RNG, then the camera."""
    trace_mod.check_supported(cfg)
    ju, jv, _, _ = rng.uniform4(pix_id, samp_id, rng.Streams.CAMERA_JITTER,
                                cfg.seed)
    x = (pix_id % width).to(torch.float32)
    y = (pix_id // width).to(torch.float32)
    u = (x + ju) / width
    v = (y + jv) / height
    rays = cam_mod.go_rays if go_camera else cam_mod.lookat_rays
    return rays(scene.camera, u, v)


def lane_radiance(scene, pix_id, samp_id, *, width: int, height: int,
                  cfg: trace_mod.TraceConfig, go_camera: bool = True):
    """(B,3) radiance of a flat wavefront of lanes, by the plain engine."""
    origin, direction = _lane_rays(scene, pix_id, samp_id, width=width,
                                   height=height, cfg=cfg,
                                   go_camera=go_camera)
    return trace_mod.trace(scene, origin.contiguous(), direction, pix_id,
                           samp_id, cfg)


def render_band(scene, band_y0: int, *, width: int, height: int,
                band_h: int, samples: int, cfg: trace_mod.TraceConfig,
                go_camera: bool = True) -> torch.Tensor:
    """Dense path: mean radiance of rows [band_y0, band_y0 + band_h),
    (band_h, W, 3), every lane traced by the plain engine."""
    n_px = band_h * width
    pixels = band_y0 * width + torch.arange(n_px, device=scene.device)
    pix, samp = _lane_ids(pixels, samples)
    rad = lane_radiance(scene, pix, samp, width=width, height=height,
                        cfg=cfg, go_camera=go_camera)
    return rad.reshape(n_px, samples, 3).mean(dim=1).reshape(
        band_h, width, 3)


# Lanes per trace launch: bounds the temporaries of ray generation (the
# int64 hash).
TRACE_LANES = 1 << 22


def _no_hook(stage, **values):
    pass


def _pixel_mask(scene, *, width: int, height: int,
                cfg: trace_mod.TraceConfig, go_camera: bool):
    """Per-pixel hit mask and its inclusive cumsum: (hit_px, pos_px). The
    mask wrapper takes K2 or K6 by the scene's kernel mode."""
    hit_px = megakernel.pixel_mask(scene, width=width, height=height,
                                   cfg=cfg, go_camera=go_camera)
    pos_px = torch.cumsum(hit_px.to(torch.int64), 0) - 1
    return hit_px, pos_px


def _compact_pixels(hit_px, pos_px, k_px: int) -> torch.Tensor:
    """Scatter the ids of the k_px hit pixels into slots [0, k_px)."""
    n = hit_px.shape[0]
    target = torch.where(hit_px, pos_px, torch.full_like(pos_px, k_px))
    out = torch.zeros(k_px + 1, dtype=torch.int64, device=hit_px.device)
    out.scatter_(0, target, torch.arange(n, device=hit_px.device))
    return out[:k_px]  # slot k_px collected the misses


def _trace_compacted_pixels(scene, px_cidx, *, width: int, height: int,
                            samples: int, cfg: trace_mod.TraceConfig,
                            go_camera: bool, hook=_no_hook) -> torch.Tensor:
    """Trace every lane of the compacted pixels with the scene's trace
    kernel (K1, K3+K4 or K7) and segment-add each pixel's samples into the
    (H,W,3) mean image, in chunks of at most TRACE_LANES lanes."""
    img = torch.zeros((width * height, 3), dtype=torch.float32,
                      device=scene.device)
    chunk = max(1, TRACE_LANES // samples)
    for c0 in range(0, px_cidx.shape[0], chunk):
        px = px_cidx[c0:c0 + chunk]
        pix, samp = _lane_ids(px, samples)
        origin, direction = _lane_rays(scene, pix, samp, width=width,
                                       height=height, cfg=cfg,
                                       go_camera=go_camera)
        hook("lane_rays", px=px, pix=pix, samp=samp, origin=origin,
             direction=direction)
        rad = megakernel.trace(scene, origin, direction, pix, samp, cfg)
        hook("trace", rad=rad)
        img.index_add_(0, px, rad.reshape(-1, samples, 3).sum(dim=1))
        hook("segment_add", img=img)
    return (img / samples).reshape(height, width, 3)


def render_wavefront(scene, *, width: int, height: int, samples: int,
                     cfg: trace_mod.TraceConfig, go_camera: bool = True,
                     hook=_no_hook) -> torch.Tensor:
    """Compacted-wavefront render: (H,W,3) mean linear radiance, on the
    scene's device.

    ``hook(stage, **values)`` is called after each stage ("mask", "count",
    "compact", then per trace chunk "lane_rays", "trace", "segment_add")
    with what the stage made, so that a profiler or a kernel check reads
    the path itself instead of repeating it."""
    hit_px, pos_px = _pixel_mask(scene, width=width, height=height, cfg=cfg,
                                 go_camera=go_camera)
    hook("mask", hit=hit_px, pos=pos_px)
    k_px = int(pos_px[-1]) + 1  # the one host read: sizes the trace
    hook("count", k=k_px)
    if k_px <= 0:
        return torch.zeros((height, width, 3), dtype=torch.float32,
                           device=scene.device)
    px_cidx = _compact_pixels(hit_px, pos_px, k_px)
    hook("compact", px=px_cidx)
    return _trace_compacted_pixels(scene, px_cidx, width=width,
                                   height=height, samples=samples, cfg=cfg,
                                   go_camera=go_camera, hook=hook)


_EFFECT_BLOCKS = ("atmospheric", "volumetric", "fog")


class Renderer:
    """Drop-in equivalent of the reference's ParallelRenderer.

    Runs on ``device`` (default CUDA; raises when there is no GPU unless
    ``device="cpu"`` is given) through the main path, ``render_wavefront``,
    in the unroll, bvh and loop modes (every scene but those past 4096
    primitives with a BVH, the stream tier, which raises).
    """

    def __init__(self, num_workers: Optional[int] = None, device=None):
        self.device = _device.resolve(device)
        self.num_workers = num_workers or (
            torch.cuda.device_count() if self.device.type == "cuda" else 1)
        self.max_depth = 50
        self.samples = 100
        self.anti_aliasing = True  # stored, never read (reference parity)
        self.recursive_reflections = True
        self.soft_shadows = True
        self.depth_of_field = False
        self.seed = 0
        self.go_camera = True
        self.fast_mc = False
        self.benchmark_data = BenchmarkData()

    # -- settings (the reference's settings.go) ---------------------------
    def set_samples(self, n):
        self.samples = int(n)

    def set_max_depth(self, n):
        self.max_depth = int(n)

    def set_anti_aliasing(self, b):
        self.anti_aliasing = bool(b)

    def set_recursive_reflections(self, b):
        self.recursive_reflections = bool(b)

    def set_soft_shadows(self, b):
        self.soft_shadows = bool(b)

    def set_depth_of_field(self, b):
        self.depth_of_field = bool(b)

    def get_stats(self):
        return {
            "samples": self.samples,
            "max_depth": self.max_depth,
            "anti_aliasing": self.anti_aliasing,
            "recursive_reflections": self.recursive_reflections,
            "soft_shadows": self.soft_shadows,
            "depth_of_field": self.depth_of_field,
            "workers": self.num_workers,
        }

    def trace_config(self) -> trace_mod.TraceConfig:
        return trace_mod.TraceConfig(
            max_depth=self.max_depth,
            soft_shadows=self.soft_shadows,
            recursive_reflections=self.recursive_reflections,
            seed=self.seed,
            depth_of_field=self.depth_of_field,
            russian_roulette_start=8 if self.fast_mc else None,
            throughput_epsilon=1e-4 if self.fast_mc else 0.0,
        )

    def render_linear_device(self, scene, width: int,
                             height: int) -> torch.Tensor:
        """(H,W,3) mean linear radiance as a tensor on the device."""
        cfg = self.trace_config()
        trace_mod.check_supported(cfg)
        return render_wavefront(scene.to(self.device), width=width,
                                height=height, samples=self.samples,
                                cfg=cfg, go_camera=self.go_camera)

    def render_linear(self, scene, width: int, height: int) -> np.ndarray:
        """(H,W,3) float32 numpy mean linear radiance."""
        return self.render_linear_device(scene, width, height).cpu().numpy()

    def render(self, scene, width: int, height: int,
               scene_config=None) -> np.ndarray:
        """Render to an (H,W,3) uint8 image and fill benchmark data.

        The scene config's renderer block (samples, maxDepth, ...) is
        honoured; its post effects are not ported yet (the post-effects
        slice, ROADMAP Queue 1 item 2) and raise when enabled."""
        self._apply_renderer_block(scene_config)
        if scene_config is not None:
            blocks = [scene_config.atmospheric, scene_config.volumetric,
                      scene_config.fog] + list(scene_config.effects.values())
            if any((b or {}).get("enabled") for b in blocks):
                raise NotImplementedError(
                    "scene post effects (atmosphere, fog, volumetric, "
                    "bloom, ...) are not ported yet: the post-effects "
                    "slice, ROADMAP Queue 1 item 2")
        t0 = time.perf_counter()
        linear = self.render_linear_device(scene, width, height)
        img = tonemap.tonemap_rgb8(linear).cpu().numpy()
        self._fill_benchmark(scene, width, height, time.perf_counter() - t0)
        return img

    def _apply_renderer_block(self, scene_config) -> None:
        if scene_config is None or not scene_config.renderer:
            return
        rb = scene_config.renderer
        if "samples" in rb:
            self.set_samples(rb["samples"])
        if "maxDepth" in rb:
            self.set_max_depth(rb["maxDepth"])
        if "antiAliasing" in rb:
            self.set_anti_aliasing(rb["antiAliasing"])
        if "recursiveReflections" in rb:
            self.set_recursive_reflections(rb["recursiveReflections"])
        if "softShadows" in rb:
            self.set_soft_shadows(rb["softShadows"])

    def _fill_benchmark(self, scene, width: int, height: int,
                        dt: float) -> None:
        bd = self.benchmark_data
        bd.scene_name = "demo_scene"
        bd.resolution = f"{width}x{height}"
        bd.render_time_seconds = dt
        bd.samples = self.samples
        bd.max_depth = self.max_depth
        bd.num_workers = self.num_workers
        bd.objects = scene.num_objects
        bd.lights = int(scene.lights.position.shape[0])
        bd.timestamp = time.strftime("%Y-%m-%dT%H:%M:%S%z")

    def save_image(self, img: np.ndarray, filename: str):
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        image_util.write_png(filename, img)

    def save_benchmark_data(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.benchmark_data.to_json())
