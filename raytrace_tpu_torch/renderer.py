"""Render pipeline: scene -> compacted wavefront -> image.

Port of the main path of ``raytrace_tpu/renderer.py``. ``render_wavefront``
is what ``Renderer.render`` runs:

1. the mask (``megakernel.pixel_mask``): a conservative per-pixel hit
   mask from one center ray per pixel against cone-inflated primitives,
   K2 (brute force), K6 (a walk over the scene BVH's inflated slabs) or
   K6-stream (the same walk, stopping at the leaf slabs);
2. pixel-granular compaction: a cumsum and a scatter of hit pixel ids;
3. camera rays for the hit pixels' lanes (pcg4d jitter, ``_lane_rays``);
4. the trace (``megakernel.trace``), by the scene's kernel mode
   (``megakernel._kernel_mode``): K1 (up to 96 primitives, 48 in a
   smooth-shaded scene), K3+K4 (97-4096 primitives with a scene BVH), K5
   (past 4096 primitives with a scene BVH; past the JAX package's
   262,144-primitive cap too, where its Renderer takes a banded jnp
   engine) or K7 (past the unroll limit without a BVH), the whole bounce
   loop per lane - in stream mode
   run as the survivor split ladder (``trace_with_split``): segments of
   bounces, each a resumable launch (K1-state), with the lanes still
   alive compacted between them;
5. a per-pixel segment-add of the samples back into the image.

A lane that misses everything is exactly black, so only hit pixels are
traced, and since every draw is keyed by (pixel, sample) and by the
absolute bounce the result equals the dense path's
(``render_band``/``lane_radiance``, which run the plain engine over every
lane and serve as the reference) up to the float reassociation of the
ladder's per-level radiance sums.

The host reads the hit-pixel count, to size the trace, and in a split
frame the ladder's overflow, once, after the trace. The JAX package's
speculative capacity cache (``_KPAD_CACHE``) is not in the port yet
(ROADMAP Queue 1 item 3).
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
from . import atmosphere as atmo_mod
from . import camera as cam_mod
from . import effects as fx
from . import rng
from . import trace as trace_mod
from ._f32 import sqrt as _sqrt
from .models import materials as mat_mod
from .ops import intersect, megakernel, tonemap
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


def _lane_ids(pixels: torch.Tensor, samples: int, offset: int = 0):
    """(pixel, sample) ids of `samples` lanes per pixel, pixel-major: the
    sample ids [offset, offset + samples) of each pixel."""
    pix = torch.repeat_interleave(pixels.to(torch.int64), samples)
    samp = torch.arange(offset, offset + samples,
                        device=pixels.device).repeat(pixels.shape[0])
    return pix, samp


def _lane_rays(scene, pix_id, samp_id, *, width: int, height: int,
               cfg: trace_mod.TraceConfig, go_camera: bool):
    """Camera rays of (pixel, sample) lanes: sub-pixel jitter from the
    counter RNG, then the camera, then with depth of field the thin lens
    (raytrace_tpu/renderer.py:164-170)."""
    ju, jv, _, _ = rng.uniform4(pix_id, samp_id, rng.Streams.CAMERA_JITTER,
                                cfg.seed)
    x = (pix_id % width).to(torch.float32)
    y = (pix_id // width).to(torch.float32)
    u = (x + ju) / width
    v = (y + jv) / height
    rays = cam_mod.go_rays if go_camera else cam_mod.lookat_rays
    origin, direction = rays(scene.camera, u, v)
    if cfg.depth_of_field:
        origin, direction = cam_mod.thin_lens_perturb(
            scene.camera, origin, direction, pix_id, samp_id, cfg.seed,
            cfg.dof_lens_radius, cfg.dof_focus_distance)
    return origin, direction


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
# Neighbouring pixels per run of the trace chunks' interleave
# (_pixel_chunks).
CHUNK_RUN = 64
# Survivor capacities of the split ladder are multiples of the JAX stream
# kernel's lane block (16 rows x 128 lanes), so they equal the JAX
# package's for the same lane count.
SPLIT_QUANTUM = 16 * 128
# The first level of the ladder keeps 1/SURV_FRAC of a chunk's lanes.
SURV_FRAC = 4
# Render configurations whose ladder overflowed: they render unsplit.
_SPLIT_BLACKLIST: set = set()


def _no_hook(stage, **values):
    pass


def _split_levels(split) -> tuple:
    """Normalise a split spec (0 | int | tuple of ascending bounces)."""
    if not split:
        return ()
    if isinstance(split, int):
        return (split,)
    return tuple(split)


def _auto_surv_cap(n_lanes: int, frac: Optional[int] = None) -> int:
    """Survivor capacity of a ladder level: 1/frac of the wavefront
    (SURV_FRAC by default), rounded up to SPLIT_QUANTUM, never above the
    wavefront rounded up (renderer.py:_auto_surv_cap :491)."""
    frac = SURV_FRAC if frac is None else frac
    q = SPLIT_QUANTUM
    return min(-(-n_lanes // q) * q, -(-max(1, n_lanes // frac) // q) * q)


def pick_deep_caps(scene) -> str:
    """Deep-level capacity policy of the ladder (:577): "const" when at
    least 5% of the spheres and triangles are glass or dielectric (glass
    chains keep lanes alive, so deep levels keep the first level's
    capacity and cannot overflow), else "shrink" (half of the level
    above). Box and plane materials are not counted, as in the JAX
    package. Reads the material ids to the host."""
    g = scene.geometry
    mats = torch.cat([g.sph_mat.reshape(-1), g.tri_mat.reshape(-1)])
    if mats.numel() == 0:
        return "shrink"
    kind = scene.materials.kind.to(mats.device)[mats.to(torch.int64)]
    refr = (kind == mat_mod.GLASS) | (kind == mat_mod.DIELECTRIC)
    return "const" if float(refr.to(torch.float32).mean()) >= 0.05 else (
        "shrink")


def pick_split(scene, cfg: trace_mod.TraceConfig):
    """The split ladder (:513): bounces at which the lanes still alive are
    compacted. Only stream-mode scenes traced to depth 12 or more split:
    from bounce 2 (shrink scenes) or 4 (const scenes), each level about
    1.45x the last (at least 3 more), up to max_depth - 2 and 8 levels.
    Returns 0, a bounce, or a tuple of bounces."""
    if megakernel._kernel_mode(scene) != "stream" or cfg.max_depth < 12:
        return 0
    b = 2 if pick_deep_caps(scene) == "shrink" else 4
    levels = []
    while b <= cfg.max_depth - 2 and len(levels) < 8:
        levels.append(b)
        b = b + max(3, int(0.45 * b))
    return tuple(levels) if len(levels) > 1 else (levels[0] if levels
                                                   else 0)


def trace_with_split(scene, origin, direction, pix, samp,
                     cfg: trace_mod.TraceConfig, *, split=0,
                     surv_cap: int = 0, deep_caps: str = "const",
                     hook=_no_hook):
    """The trace with mid-trace survivor re-compaction (:259): returns
    (radiance (B,3), overflow), overflow a 0-d int64 tensor on the device.

    Each level runs its bounce segment with ``megakernel.trace`` (resumable
    launches, K1-state), compacts the lanes still alive into a capacity
    (a cumsum, a scatter of lane ids and gathers), and goes on with the
    compacted state from the level's bounce. The first level's capacity is
    ``surv_cap``; deeper levels keep it ("const") or take half of it
    ("shrink"). Survivors past a capacity are dropped and counted in
    overflow: a caller that sees overflow > 0 must trace again unsplit.
    Otherwise the radiance is the unsplit trace's up to one float add per
    level. ``hook`` sees each segment ("segment": its bounces, inputs
    and outputs: ``rad``, which a level that splits then adds the deeper
    levels into in place, and ``state``, None for the last segment) and
    each compaction ("split_compact": survivors and capacity)."""
    levels = tuple(b for b in _split_levels(split) if 0 < b < cfg.max_depth)
    zero = torch.zeros((), dtype=torch.int64, device=origin.device)

    def go(o, d, px_, sp_, tp, al, b0, rest, cap0, level):
        seg = dict(start_bounce=b0)
        if b0 > 0:
            seg.update(init_throughput=tp, init_alive=al)
        if not rest:
            rad = megakernel.trace(scene, o, d, px_, sp_, cfg, **seg)
            hook("segment", b0=b0, b1=cfg.max_depth, origin=o, direction=d,
                 pix=px_, samp=sp_, throughput=tp, alive=al, rad=rad,
                 state=None)
            return rad, zero
        b1 = rest[0]
        n = o.shape[0]
        if cap0 > 0:
            cap = min(n, cap0)
        elif deep_caps == "const":
            cap = n  # alive lanes never resurrect: no deep overflow
        else:
            cap = _auto_surv_cap(n, frac=2)
        rad_a, st = megakernel.trace(scene, o, d, px_, sp_, cfg,
                                     end_bounce=b1, return_state=True, **seg)
        hook("segment", b0=b0, b1=b1, origin=o, direction=d, pix=px_,
             samp=sp_, throughput=tp, alive=al, rad=rad_a, state=st)
        alive = st["alive"] > 0.0
        pos = torch.cumsum(alive.to(torch.int64), 0) - 1
        k_surv = pos[-1] + 1
        overflow = torch.clamp(k_surv - cap, min=0)
        target = torch.where(alive, torch.clamp(pos, max=cap - 1),
                             torch.full_like(pos, cap))
        sidx = torch.zeros(cap + 1, dtype=torch.int64, device=o.device)
        sidx.scatter_(0, target, torch.arange(n, device=o.device))
        sidx = sidx[:cap]  # slot cap collected the dead lanes
        valid = torch.arange(cap, device=o.device) < torch.clamp(k_surv,
                                                                 max=cap)
        take = lambda t: t.index_select(0, sidx)
        hook("split_compact", level=level, bounce=b1, lanes=n, cap=cap,
             survivors=k_surv)
        rad_b, ov_deep = go(
            take(st["origin"]), take(st["direction"]), take(px_),
            take(sp_), take(st["throughput"]),
            torch.where(valid, take(st["alive"]), 0.0), b1, rest[1:], 0,
            level + 1)
        rad_b = torch.where(valid[:, None], rad_b, 0.0)
        return rad_a.index_add_(0, sidx, rad_b), overflow + ov_deep

    return go(origin, direction, pix, samp, None, None, 0, levels, surv_cap,
              0)


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


def _pixel_chunks(px_cidx, samples: int, interleave: bool):
    """The compacted pixels in trace chunks of at most TRACE_LANES lanes:
    consecutive pixels, or with ``interleave`` (a split frame) runs of
    CHUNK_RUN neighbouring pixels dealt out in turn - chunk c of n takes
    runs c, c + n, c + 2n, ... - so that each chunk is a sample of the
    whole frame. A ladder level's survivors are then about the frame's
    share, where a chunk of neighbouring rows over glass keeps more lanes
    alive than the first capacity (a quarter of them) and overflows. An
    unsplit frame keeps consecutive chunks: interleaved ones slowed K3+K4
    on ring-1000, each launch then holding the frame's slowest pixels."""
    n = px_cidx.shape[0]
    chunk = max(1, TRACE_LANES // samples)
    if n <= chunk:
        return [px_cidx]
    if not interleave:
        return list(px_cidx.split(chunk))
    runs_per_chunk = max(1, chunk // CHUNK_RUN)
    n_chunks = -(-(-(-n // CHUNK_RUN)) // runs_per_chunk)
    run = torch.arange(n, device=px_cidx.device) // CHUNK_RUN % n_chunks
    return [px_cidx[run == c] for c in range(n_chunks)]


def _trace_compacted_pixels(scene, px_cidx, *, width: int, height: int,
                            samples: int, cfg: trace_mod.TraceConfig,
                            go_camera: bool, split=0,
                            deep_caps: str = "const", hook=_no_hook):
    """Trace every lane of the compacted pixels with the scene's trace
    kernel and segment-add each pixel's samples into the (H,W,3) mean
    image, in chunks of at most TRACE_LANES lanes (``_pixel_chunks``),
    each chunk through the split ladder (``trace_with_split``; first-level
    capacity from the chunk's lane count). Returns (image, overflow summed
    over the chunks, a 0-d tensor on the device)."""
    img = torch.zeros((width * height, 3), dtype=torch.float32,
                      device=scene.device)
    overflow = torch.zeros((), dtype=torch.int64, device=scene.device)
    for px in _pixel_chunks(px_cidx, samples, interleave=bool(split)):
        pix, samp = _lane_ids(px, samples)
        origin, direction = _lane_rays(scene, pix, samp, width=width,
                                       height=height, cfg=cfg,
                                       go_camera=go_camera)
        hook("lane_rays", px=px, pix=pix, samp=samp, origin=origin,
             direction=direction)
        rad, ov = trace_with_split(
            scene, origin, direction, pix, samp, cfg, split=split,
            surv_cap=_auto_surv_cap(pix.shape[0]) if split else 0,
            deep_caps=deep_caps, hook=hook)
        overflow = overflow + ov
        hook("trace", rad=rad)
        img.index_add_(0, px, rad.reshape(-1, samples, 3).sum(dim=1))
        hook("segment_add", img=img)
    return (img / samples).reshape(height, width, 3), overflow


def render_wavefront(scene, *, width: int, height: int, samples: int,
                     cfg: trace_mod.TraceConfig, go_camera: bool = True,
                     hook=_no_hook) -> torch.Tensor:
    """Compacted-wavefront render: (H,W,3) mean linear radiance, on the
    scene's device.

    The trace runs the split ladder of ``pick_split`` (stream mode at
    depth 12 or more) unless this configuration overflowed before
    (``_SPLIT_BLACKLIST``); a frame whose ladder overflows is blacklisted
    and traced again unsplit.

    ``hook(stage, **values)`` is called after each stage ("mask", "count",
    "compact", then per trace chunk "lane_rays", the ladder's "segment"
    and "split_compact" stages, "trace", "segment_add", and in a split
    frame "overflow") with what the stage made, so that a profiler or a
    kernel check reads the path itself instead of repeating it."""
    key = (width, height, samples, cfg, go_camera)
    split = 0 if key in _SPLIT_BLACKLIST else pick_split(scene, cfg)
    deep_caps = pick_deep_caps(scene) if split else "const"
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
    trace_px = lambda sp: _trace_compacted_pixels(
        scene, px_cidx, width=width, height=height, samples=samples,
        cfg=cfg, go_camera=go_camera, split=sp, deep_caps=deep_caps,
        hook=hook)
    img, overflow = trace_px(split)
    if split:
        ov = int(overflow)  # the ladder's one host read, after the trace
        hook("overflow", overflow=ov)
        if ov > 0:
            _SPLIT_BLACKLIST.add(key)
            img, _ = trace_px(0)
    return img


class Renderer:
    """Drop-in equivalent of the reference's ParallelRenderer.

    Runs on ``device`` (default CUDA; raises when there is no GPU unless
    ``device="cpu"`` is given) through the main path, ``render_wavefront``,
    in the unroll, bvh, stream and loop modes: every scene, those past the
    JAX package's 262,144-primitive cap in stream mode (up to
    ``megakernel.MAX_STREAM_ROWS``). ``render_adaptive`` runs the adaptive
    sampler over the same kernels, and ``render(..., denoise=True)`` the
    AOV-guided denoiser.
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
        return render_wavefront(scene.to(self.device), width=width,
                                height=height, samples=self.samples,
                                cfg=cfg, go_camera=self.go_camera)

    def render_linear(self, scene, width: int, height: int) -> np.ndarray:
        """(H,W,3) float32 numpy mean linear radiance."""
        return self.render_linear_device(scene, width, height).cpu().numpy()

    def render(self, scene, width: int, height: int,
               scene_config=None, denoise: bool = False) -> np.ndarray:
        """Render to an (H,W,3) uint8 image and fill benchmark data.

        With a scene config, its renderer block (samples, maxDepth, ...) is
        honoured, and its atmospheric, fog, volumetric and post-FX blocks
        run on the linear image (``_apply_scene_effects``) before the tone
        map, as in the JAX package's ``Renderer.render``. ``denoise`` runs
        the AOV-guided cross-bilateral filter (``denoising.py``) on the
        linear image first."""
        self._apply_renderer_block(scene_config)
        t0 = time.perf_counter()
        linear = self.render_linear_device(scene, width, height)
        if denoise:
            linear = self._denoise_linear(scene, linear, width, height)
        if scene_config is not None:
            linear = self._apply_scene_effects(scene, linear, width, height,
                                               scene_config)
        img = tonemap.tonemap_rgb8(linear).cpu().numpy()
        self._fill_benchmark(scene, width, height, time.perf_counter() - t0)
        return img

    def render_adaptive(self, scene, width: int, height: int,
                        scene_config=None, min_spp: int = 8,
                        rel_tol: float = 0.02, abs_tol: float = 1e-4,
                        batch: Optional[int] = None, denoise: bool = False,
                        hook=_no_hook):
        """Adaptive-spp render to ((H,W,3) uint8, (H,W) int32 spp map).

        ``self.samples`` is the per-pixel cap; a pixel stops once its
        luminance standard error clears the tolerance (``adaptive.py``,
        whose stage ``hook`` this passes on; device accumulation on the
        card, host accumulation on the CPU). The scene config's blocks are
        honoured as in ``render``. ``denoise`` runs the AOV-guided filter
        with the sampler's own variance map in its radiance term. The
        pipeline stays on the device up to the uint8 image;
        ``benchmark_data.samples`` records the mean spp taken."""
        from . import adaptive as adaptive_mod
        self._apply_renderer_block(scene_config)
        t0 = time.perf_counter()
        linear, spp, var = adaptive_mod.render_adaptive(
            scene, width=width, height=height, cfg=self.trace_config(),
            min_spp=min(min_spp, self.samples), max_spp=self.samples,
            batch=batch or max(1, min(8, min_spp)), rel_tol=rel_tol,
            abs_tol=abs_tol, go_camera=self.go_camera,
            return_variance=True, as_numpy=False,
            device=self.device, hook=hook)
        if denoise:
            linear = self._denoise_linear(scene, linear, width, height,
                                          variance=var)
        if scene_config is not None:
            linear = self._apply_scene_effects(scene, linear, width, height,
                                               scene_config)
        img = tonemap.tonemap_rgb8(linear).cpu().numpy()
        spp = spp.cpu().numpy().astype(np.int32)
        self._fill_benchmark(scene, width, height, time.perf_counter() - t0,
                             samples=float(spp.mean()))
        return img, spp

    def _denoise_linear(self, scene, linear, width: int, height: int,
                        variance=None) -> torch.Tensor:
        """The AOV-guided cross-bilateral filter on a linear (H,W,3) image,
        on the device (the callers tone-map there)."""
        from . import aov as aov_mod
        from . import denoising
        aovs = aov_mod.render_aovs(scene, width=width, height=height,
                                   go_camera=self.go_camera, as_numpy=False,
                                   device=self.device)
        return denoising.denoise(linear, aovs, variance=variance,
                                 as_numpy=False, device=self.device)

    def _primary_depth(self, scene, width: int,
                       height: int) -> torch.Tensor:
        """(H,W) distance to each pixel's center-ray closest hit (BIG on a
        miss), for fog and the depth-of-field blur: t * |d|, the directions
        being unnormalised. With a scene BVH the closest hit walks it."""
        scene = scene.to(self.device)
        o, d = atmo_mod.center_rays(scene, width, height, self.go_camera)
        chunk = atmo_mod.center_chunk(scene)
        dist = []
        for i in range(0, o.shape[0], chunk):
            oc, dc = o[i:i + chunk], d[i:i + chunk]
            hit = intersect.closest_hit(scene.geometry, oc, dc, t_min=1e-3,
                                        accel=scene.accel)
            n = _sqrt(dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1]
                      + dc[:, 2] * dc[:, 2])
            dist.append(torch.where(hit.hit, hit.t * n,
                                    torch.full_like(n, intersect.BIG)))
        return torch.cat(dist).reshape(height, width)

    def _apply_scene_effects(self, scene, linear, width: int, height: int,
                             scene_config, hook=_no_hook) -> torch.Tensor:
        """The atmospheric, fog, volumetric and post-FX blocks of a scene
        config on a linear (H,W,3) image, on the device, in the JAX
        package's order (raytrace_tpu/renderer.py:1095-1155): sky into the
        miss pixels, fog by the primary depth, the volumetric in-scatter
        along the center rays, then the post-FX blocks. ``hook(stage,
        **values)`` is called after each stage that runs ("depth", "sky",
        "fog", "volumetric", "config_effects")."""
        scene = scene.to(self.device)
        blocks = dict(scene_config.effects or {})
        atmo_blk = scene_config.atmospheric or {}
        fog_blk = scene_config.fog or {}
        vol_blk = scene_config.volumetric or {}
        need_depth = (fog_blk.get("enabled")
                      or (blocks.get("depthOfField") or {}).get("enabled"))
        img = linear.to(self.device, torch.float32)
        depth = None
        if need_depth:
            depth = self._primary_depth(scene, width, height)
            hook("depth", depth=depth)
        if atmo_blk.get("enabled"):
            img = atmo_mod.apply_sky_to_image(
                scene, img, width, height,
                atmo_mod.settings_from_config(atmo_blk),
                go_camera=self.go_camera)
            hook("sky", img=img)
        if fog_blk.get("enabled"):
            img = fx.apply_fog(
                img, torch.clamp(depth, max=1e4),
                fog_color=tuple(fog_blk.get("color", (0.75, 0.78, 0.82))),
                mode=str(fog_blk.get("mode", "exp")),
                density=float(fog_blk.get("density", 0.02)),
                start=float(fog_blk.get("start", 0.0)),
                end=float(fog_blk.get("end", 100.0)))
            hook("fog", img=img)
        if vol_blk.get("enabled"):
            o, d = atmo_mod.center_rays(scene, width, height, self.go_camera)
            vol = fx.volumetric_light(
                o, d, torch.full((o.shape[0],),
                                 float(vol_blk.get("maxDist", 20.0)),
                                 device=img.device),
                scene.lights, steps=int(vol_blk.get("steps", 64)),
                density=float(vol_blk.get("density", 0.02)),
                scattering=float(vol_blk.get("scattering", 0.5)))
            img = img + vol.reshape(height, width, 3)
            hook("volumetric", img=img)
        img = fx.apply_config_effects(img, blocks, depth=depth)
        hook("config_effects", img=img)
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
                        dt: float, samples=None) -> None:
        bd = self.benchmark_data
        bd.scene_name = "demo_scene"
        bd.resolution = f"{width}x{height}"
        bd.render_time_seconds = dt
        bd.samples = self.samples if samples is None else samples
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

    def print_ascii_preview(self, img: np.ndarray):
        """PrintASCIIPreview (renderer.go:453-471): every second row, one
        character a pixel by its brightness."""
        chars = " .:-=+*#%@"
        h, w = img.shape[:2]
        lines = []
        for y in range(0, h, 2):
            row = []
            for x in range(w):
                # Go reads 16-bit RGBA and averages (renderer.go:461-462)
                r, g, b = (int(v) * 257 for v in img[y, x][:3])
                brightness = (r + g + b) / 3.0
                ci = min(int(brightness * (len(chars) - 1) / 65535.0),
                         len(chars) - 1)
                row.append(chars[ci])
            lines.append("".join(row))
        print("\n".join(lines))
