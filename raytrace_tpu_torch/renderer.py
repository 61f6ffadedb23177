"""Render pipeline: scene -> compacted wavefront -> image.

Port of the main path of ``raytrace_tpu/renderer.py``. ``render_wavefront``
is what ``Renderer.render`` runs:

1. the mask (``megakernel.pixel_mask``): a conservative per-pixel hit
   mask from one center ray per pixel against cone-inflated primitives,
   K2 (brute force), K6 (a walk over the scene BVH's inflated slabs) or
   K6-stream (the same walk, stopping at the leaf slabs);
2. pixel-granular compaction into a static capacity ``k_pad``: a cumsum
   and a scatter of the hit pixel ids; the slots past the hit count point
   at a pixel the mask rejected (every lane of it is black and ends at
   its first hit test) and are left out of the image;
3. camera rays for the compacted pixels' lanes (pcg4d jitter,
   ``_lane_rays``);
4. the trace (``megakernel.trace``), by the scene's kernel mode
   (``megakernel._kernel_mode``): K1 (up to 96 primitives, 48 in a
   smooth-shaded scene), K3+K4 (97-4096 primitives with a scene BVH), K5
   (past 4096 primitives with a scene BVH; past the JAX package's
   262,144-primitive cap too, where its Renderer takes a banded jnp
   engine) or K7 (past the unroll limit without a BVH), the whole bounce
   loop per lane - in stream mode run as the survivor split ladder
   (``trace_with_split``): segments of bounces, each a resumable launch
   (K1-state), with the lanes still alive compacted between them;
5. a per-pixel segment-add of the samples back into the image, then
   ``post`` (e.g. ``tonemap.tonemap_rgb8``) on the device.

A lane that misses everything is exactly black, so only hit pixels are
traced, and since every draw is keyed by (pixel, sample) and by the
absolute bounce the result equals the dense path's
(``render_band``/``lane_radiance``, which run the plain engine over every
lane and serve as the reference) up to the float reassociation of the
ladder's per-level radiance sums.

The speculative capacity path (``raytrace_tpu/renderer.py:398-488``,
``:614-702``): the first frame of a configuration (``capacity_key``)
reads the hit-pixel count once, sizes ``k_pad`` (``_capacity``) and
caches it (``_KPAD_CACHE``, a FIFO of 64). A later frame of the same key
runs the whole path at the cached capacity with no host read before the
trace. Without ``assume_capacity`` one transfer then reads the hit count
and the ladder's overflow: a stale capacity renders the frame again at a
new one, an overflow blacklists the key (``_SPLIT_BLACKLIST``) and
renders it unsplit. With ``assume_capacity`` the two flags stay on the
device (``_PENDING_CHECKS``) until ``flush_capacity_checks`` reads a
whole batch of them in one transfer and raises on a stale capacity or an
overflow: such a frame reads nothing from the device, and nothing is
dropped silently. ``render_wavefront_chunked`` traces a frame in rounds
of samples over one mask and one capacity.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import weakref
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
    sample ids [offset, offset + samples) of each pixel. (An expand, not
    ``repeat_interleave``, which may read its output size on the host.)"""
    pix = pixels.to(torch.int64)[:, None].expand(-1, samples).reshape(-1)
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
# Render configurations (``capacity_key``) whose ladder overflowed: they
# render unsplit.
_SPLIT_BLACKLIST: set = set()
# The speculative capacity cache of the fused frame: capacity_key -> the
# last validated k_pad. A bounded FIFO: the key holds cfg, and so the
# seed, which a progressive render changes every frame.
_KPAD_CACHE: dict = {}
_KPAD_CACHE_MAX = 64
# Deferred capacity flags of assume_capacity frames: (key, hit count,
# k_pad, overflow), the count and the overflow 0-d tensors on the device.
# flush_capacity_checks reads them; past _PENDING_MAX it runs by itself.
_PENDING_CHECKS: list = []
_PENDING_MAX = 1024
# pick_deep_caps by scene object: {id: (weak reference, policy)}.
_DEEP_CAPS: dict = {}


def _no_hook(stage, **values):
    pass


def _fifo_put(cache: dict, key, value) -> None:
    """Insert into a FIFO of at most _KPAD_CACHE_MAX entries."""
    if key not in cache and len(cache) >= _KPAD_CACHE_MAX:
        cache.pop(next(iter(cache)))
    cache[key] = value


def _kpad_cache_put(key, value) -> None:
    _fifo_put(_KPAD_CACHE, key, value)


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
    least 5% of the material ids of the geometry tables - spheres,
    triangles (a cube's 12 faces among them), planes and boxes - are glass
    or dielectric (glass chains keep lanes alive, so deep levels keep the
    first level's capacity and cannot overflow), else "shrink" (half of
    the level above). The JAX package counts spheres and triangles only
    (a parity departure: its planes and boxes never count). Reads the
    material ids to the host once per scene object, whose answer
    ``_DEEP_CAPS`` keeps, so a steady-state frame reads nothing."""
    seen = _DEEP_CAPS.get(id(scene))
    if seen is not None and seen[0]() is scene:
        return seen[1]
    g = scene.geometry
    mats = torch.cat([g.sph_mat.reshape(-1), g.tri_mat.reshape(-1),
                      g.pl_mat.reshape(-1), g.box_mat.reshape(-1)])
    caps = "shrink"
    if mats.numel():
        kind = scene.materials.kind.to(mats.device)[mats.to(torch.int64)]
        refr = (kind == mat_mod.GLASS) | (kind == mat_mod.DIELECTRIC)
        if float(refr.to(torch.float32).mean()) >= 0.05:
            caps = "const"
    _fifo_put(_DEEP_CAPS, id(scene), (weakref.ref(scene), caps))
    return caps


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


def _compact_pixels(hit_px, pos_px, k_pad: int) -> torch.Tensor:
    """Scatter the ids of the hit pixels into slots [0, k_pad), with no
    host read: the first k_pad hit pixels in order, and where there are
    fewer, the slots past them hold the first pixel the mask rejected
    (every lane of it misses, so it ends at its first hit test; the
    segment-add leaves those slots out). At k_pad = the hit count the
    slots are exactly the hit pixels."""
    n = hit_px.shape[0]
    dump = torch.full_like(pos_px, k_pad)
    target = torch.where(hit_px & (pos_px < k_pad), pos_px, dump)
    miss = torch.argmin(hit_px.to(torch.uint8)).reshape(1)
    out = miss.repeat(k_pad + 1)
    out.scatter_(0, target, torch.arange(n, device=hit_px.device))
    return out[:k_pad]  # slot k_pad collected the misses


def _pixel_chunks(n: int, samples: int, interleave: bool, device):
    """Slots [0, n) of the compacted pixels in trace chunks of at most
    TRACE_LANES lanes: slices of consecutive slots, or with ``interleave``
    (a split frame) index tensors of runs of CHUNK_RUN neighbouring slots
    dealt out in turn - chunk c of m takes runs c, c + m, c + 2m, ... - so
    that each chunk is a sample of the whole frame. A ladder level's
    survivors are then about the frame's share, where a chunk of
    neighbouring rows over glass keeps more lanes alive than the first
    capacity (a quarter of them) and overflows. An unsplit frame keeps
    consecutive chunks: interleaved ones slowed K3+K4 on ring-1000, each
    launch then holding the frame's slowest pixels. n is the static
    capacity, so the layout is index arithmetic with no host read."""
    chunk = max(1, TRACE_LANES // samples)
    if n <= chunk or not interleave:
        return [slice(s, min(n, s + chunk)) for s in range(0, n, chunk)]
    runs_per_chunk = max(1, chunk // CHUNK_RUN)
    n_runs = -(-n // CHUNK_RUN)
    n_chunks = -(-n_runs // runs_per_chunk)
    within = torch.arange(CHUNK_RUN, device=device)
    out = []
    for c in range(n_chunks):
        runs = torch.arange(c, n_runs, n_chunks, device=device)
        slots = (runs[:, None] * CHUNK_RUN + within).reshape(-1)
        if (n_runs - 1 - c) % n_chunks == 0:  # the last run is partial
            slots = slots[:slots.shape[0] - (n_runs * CHUNK_RUN - n)]
        out.append(slots)
    return out


def _trace_compacted_pixels(scene, px_cidx, k, *, width: int, height: int,
                            samples: int, cfg: trace_mod.TraceConfig,
                            go_camera: bool, split=0,
                            deep_caps: str = "const", offset: int = 0,
                            sum_image: bool = False, row0: int = 0,
                            rows: Optional[int] = None, hook=_no_hook):
    """Trace every lane of the compacted pixels with the scene's trace
    kernel and segment-add each pixel's samples into the (H,W,3) mean
    image (with ``sum_image`` the sum, which render_wavefront_chunked
    divides), in chunks of at most TRACE_LANES lanes (``_pixel_chunks``),
    each chunk through the split ladder (``trace_with_split``; first-level
    capacity from the chunk's lane count). ``k`` (a 0-d tensor) is the hit
    count: the slots from k on are padding and add into a row past the
    image. The lanes take the sample ids [offset, offset + samples). With
    ``rows``, the pixels lie in the row band [row0, row0 + rows) (a px
    shard's, ``parallel.shard``) and the image is that band's, (rows,W,3).
    Returns (image, overflow summed over the chunks, a 0-d tensor on the
    device)."""
    rows = height - row0 if rows is None else rows
    n_px = width * rows
    dev = scene.device
    img = torch.zeros((n_px + 1, 3), dtype=torch.float32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    dump = torch.full((), n_px, dtype=torch.int64, device=dev)
    for sl in _pixel_chunks(px_cidx.shape[0], samples, bool(split), dev):
        px = px_cidx[sl]
        slots = (torch.arange(sl.start, sl.stop, device=dev)
                 if isinstance(sl, slice) else sl)
        pix, samp = _lane_ids(px, samples, offset)
        origin, direction = _lane_rays(scene, pix, samp, width=width,
                                       height=height, cfg=cfg,
                                       go_camera=go_camera)
        hook("lane_rays", px=px, slots=slots, pix=pix, samp=samp,
             origin=origin, direction=direction)
        rad, ov = trace_with_split(
            scene, origin, direction, pix, samp, cfg, split=split,
            surv_cap=_auto_surv_cap(pix.shape[0]) if split else 0,
            deep_caps=deep_caps, hook=hook)
        overflow = overflow + ov
        hook("trace", rad=rad)
        img.index_add_(0, torch.where(slots < k, px - row0 * width, dump),
                       rad.reshape(-1, samples, 3).sum(dim=1))
        hook("segment_add", img=img)
    img = img[:n_px].reshape(rows, width, 3)
    return (img if sum_image else img / samples), overflow


def capacity_key(width: int, height: int, samples: int,
                 cfg: trace_mod.TraceConfig, go_camera: bool, post,
                 device, *more) -> tuple:
    """The key of _KPAD_CACHE and _SPLIT_BLACKLIST: the JAX package's
    (raytrace_tpu/renderer.py:633) without its block_rows, with the
    device; ``more`` marks render_wavefront_chunked's keys."""
    return (width, height, samples, cfg, go_camera, post,
            torch.device(device)) + more


def _pad_bucket(k: int, quantum: int) -> int:
    """The capacity for k hit pixels: k rounded up to whole quanta, and
    the count of quanta rounded up to four significant bits, so that the
    padding adds less than an eighth to the quanta k needs. (The JAX
    package rounds to a power of two, against XLA recompiles, which
    PyTorch does not have.)"""
    blocks = max(1, -(-k // quantum))
    step = 1 << max(0, (blocks - 1).bit_length() - 4)
    return quantum * (-(-blocks // step) * step)


def _quantum(samples: int) -> int:
    """Pixels of one SPLIT_QUANTUM lane block at ``samples`` a pixel."""
    return max(1, SPLIT_QUANTUM // max(1, samples))


def _capacity(k: int, samples: int, n_px: int) -> int:
    """The capacity of a frame with k hit pixels: ``_pad_bucket``, never
    past the frame's pixels, nor into a trace chunk that k itself does not
    need (a chunk of padding alone would cost its lane rays and a launch
    of every ladder level). Chunks are counted as the interleaved ones
    hold pixels (whole runs), which is never more than the consecutive
    ones hold."""
    chunk = max(1, TRACE_LANES // samples)
    if chunk >= CHUNK_RUN:
        chunk = chunk // CHUNK_RUN * CHUNK_RUN
    return min(_pad_bucket(k, _quantum(samples)), n_px,
               -(-k // chunk) * chunk)


def _defer_check(key, k, k_pad: int, overflow) -> None:
    """Record an assume_capacity frame's flags for flush_capacity_checks,
    which runs by itself past _PENDING_MAX pending frames."""
    _PENDING_CHECKS.append((key, k, k_pad, overflow))
    if len(_PENDING_CHECKS) > _PENDING_MAX:
        flush_capacity_checks()


def flush_capacity_checks() -> int:
    """Read the deferred flags of the assume_capacity frames since the
    last flush, in one transfer a device (the flags are stacked on the
    device first), and raise RuntimeError if a frame's hit count exceeded
    its cached capacity (pixels were dropped: the key leaves _KPAD_CACHE,
    so its next frame sizes again) or its ladder overflowed (survivors
    were dropped: the key renders unsplit from then on). Returns the
    number of frames validated."""
    pending = list(_PENDING_CHECKS)
    _PENDING_CHECKS.clear()
    flags = {}
    for dev in {k.device for _, k, _, _ in pending}:
        rows = [i for i, p in enumerate(pending) if p[1].device == dev]
        read = torch.stack([torch.stack([pending[i][1], pending[i][3]])
                            for i in rows]).tolist()
        flags.update(zip(rows, read))
    for i, (key, _, k_pad, _) in enumerate(pending):
        k, ov = flags[i]
        if ov > 0:
            _SPLIT_BLACKLIST.add(key)
            raise RuntimeError(
                f"an assume_capacity frame overflowed the split ladder's "
                f"survivor capacity by {ov} lanes; render it again without "
                f"assume_capacity (the configuration now renders unsplit)")
        if k > k_pad:
            _KPAD_CACHE.pop(key, None)
            raise RuntimeError(
                f"an assume_capacity frame dropped pixels: {k} hit pixels "
                f"past its cached capacity of {k_pad} (the scene changed); "
                f"render it again without assume_capacity")
    return len(pending)


def _finish(img, post, as_numpy: bool):
    if post is not None:
        img = post(img)
    return img.cpu().numpy() if as_numpy else img


def _black(scene, width: int, height: int) -> torch.Tensor:
    return torch.zeros((height, width, 3), dtype=torch.float32,
                       device=scene.device)


def render_wavefront(scene, *, width: int, height: int, samples: int,
                     cfg: trace_mod.TraceConfig, go_camera: bool = True,
                     as_numpy: bool = False, assume_capacity: bool = False,
                     post=None, hook=_no_hook):
    """Compacted-wavefront render: (H,W,3) mean linear radiance, a tensor
    on the scene's device (``as_numpy``: the host array), or ``post`` of
    it (a function of the image run on the device, e.g.
    ``tonemap.tonemap_rgb8``).

    The first frame of a key (``capacity_key``) reads the hit count and
    sizes the capacity from it (``_capacity``); later frames run at the
    cached capacity with no host read before the trace. Without
    ``assume_capacity`` one transfer then reads the count and the
    ladder's overflow: the frame is kept if count <= k_pad <= max(2 *
    the count's capacity, one quantum), else rendered again at a new
    capacity (reusing the mask), and an overflow blacklists the key and
    renders the frame unsplit. With ``assume_capacity`` (the caller
    asserts that the scene has not changed since a validated frame) the
    frame reads nothing from the device: its flags wait for
    ``flush_capacity_checks``.

    The trace runs the split ladder of ``pick_split`` (stream mode at
    depth 12 or more) unless this key overflowed before
    (``_SPLIT_BLACKLIST``).

    ``hook(stage, **values)`` is called after each stage ("mask", on the
    first frame of a key "count", then "compact", per trace chunk
    "lane_rays", the ladder's "segment" and "split_compact" stages,
    "trace", "segment_add"; after a validated frame "check" with the
    count and the overflow, and "retry" before a frame is rendered again;
    in a split frame "overflow") with what the stage made, so that a
    profiler or a kernel check reads the path itself instead of repeating
    it."""
    key = capacity_key(width, height, samples, cfg, go_camera, post,
                       scene.device)
    split = 0 if key in _SPLIT_BLACKLIST else pick_split(scene, cfg)
    deep_caps = pick_deep_caps(scene) if split else "const"
    n_px = width * height
    hit_px, pos_px = _pixel_mask(scene, width=width, height=height, cfg=cfg,
                                 go_camera=go_camera)
    hook("mask", hit=hit_px, pos=pos_px)
    k_dev = pos_px[-1] + 1

    def trace_px(sp, k_pad):
        px_cidx = _compact_pixels(hit_px, pos_px, k_pad)
        hook("compact", px=px_cidx)
        return _trace_compacted_pixels(
            scene, px_cidx, k_dev, width=width, height=height,
            samples=samples, cfg=cfg, go_camera=go_camera, split=sp,
            deep_caps=deep_caps, hook=hook)

    k_pad = _KPAD_CACHE.get(key)
    if k_pad is not None:
        img, ov_dev = trace_px(split, k_pad)
        if assume_capacity:
            _defer_check(key, k_dev, k_pad, ov_dev)
            return _finish(img, post, as_numpy)
        k_px, ov = torch.stack([k_dev, ov_dev]).tolist()  # one transfer
        hook("check", k=k_px, overflow=ov)
        if split:
            hook("overflow", overflow=ov)
        if ov > 0:
            _SPLIT_BLACKLIST.add(key)
            split = 0
        else:
            want = _capacity(max(k_px, 1), samples, n_px)
            if k_px <= k_pad <= max(2 * want, _quantum(samples)):
                _kpad_cache_put(key, want if k_px > 0 else k_pad)
                return _finish(img, post, as_numpy)
        hook("retry", k=k_px, k_pad=k_pad, overflow=ov)
    else:
        k_px = int(k_dev)  # the first frame's one read: sizes the capacity
        hook("count", k=k_px)
    if k_px <= 0:
        return _finish(_black(scene, width, height), post, as_numpy)
    k_pad = _capacity(k_px, samples, n_px)
    _kpad_cache_put(key, k_pad)
    img, ov_dev = trace_px(split, k_pad)
    if split:
        ov = int(ov_dev)  # the ladder's one read, after the trace
        hook("overflow", overflow=ov)
        if ov > 0:
            _SPLIT_BLACKLIST.add(key)
            img, _ = trace_px(0, k_pad)
    return _finish(img, post, as_numpy)


def pick_chunk_spp(scene, samples: int, cfg: trace_mod.TraceConfig) -> int:
    """Samples a round of render_wavefront_chunked (:705): 10 for a
    stream-mode scene, else the whole frame. (The JAX package's
    RT_CHUNK_SPP is not read: the ``chunk`` argument overrides.)"""
    if megakernel._kernel_mode(scene) == "stream":
        return min(samples, 10)
    return samples


def render_wavefront_chunked(scene, *, width: int, height: int,
                             samples: int, cfg: trace_mod.TraceConfig,
                             chunk: Optional[int] = None,
                             go_camera: bool = True, as_numpy: bool = False,
                             assume_capacity: bool = False, post=None,
                             hook=_no_hook):
    """render_wavefront in rounds of at most ``chunk`` samples
    (``pick_chunk_spp`` by default; chunk >= samples goes through
    render_wavefront).

    Round r traces the sample ids [r*chunk, r*chunk + c) of every
    compacted pixel, which are the lanes the one-round frame traces, and
    adds its per-pixel sums into a sum image on the device (one float add
    a round boundary). The mask runs once, and one capacity (cached under
    the key of this chunk size) serves every round. Without
    ``assume_capacity`` the frame reads its hit count and sizes the
    capacity, and an overflow of the ladder blacklists the key and
    renders the frame again unsplit; with it (and a cached capacity) the
    frame reads nothing and records one deferred flag for
    ``flush_capacity_checks``. ``hook`` sees the stages of
    render_wavefront and "round" before each round."""
    if chunk is None:
        chunk = pick_chunk_spp(scene, samples, cfg)
    chunk = max(1, min(chunk, samples))
    kw = dict(width=width, height=height, samples=samples, cfg=cfg,
              go_camera=go_camera, as_numpy=as_numpy, post=post, hook=hook)
    if chunk >= samples:
        return render_wavefront(scene, assume_capacity=assume_capacity, **kw)
    key = capacity_key(width, height, samples, cfg, go_camera, post,
                       scene.device, "chunked", chunk)
    split = 0 if key in _SPLIT_BLACKLIST else pick_split(scene, cfg)
    deep_caps = pick_deep_caps(scene) if split else "const"
    hit_px, pos_px = _pixel_mask(scene, width=width, height=height, cfg=cfg,
                                 go_camera=go_camera)
    hook("mask", hit=hit_px, pos=pos_px)
    k_dev = pos_px[-1] + 1
    k_pad = _KPAD_CACHE.get(key)
    if k_pad is None or not assume_capacity:
        k_px = int(k_dev)  # sizes the capacity
        hook("count", k=k_px)
        if k_px <= 0:
            return _finish(_black(scene, width, height), post, as_numpy)
        k_pad = _capacity(k_px, chunk, width * height)
        _kpad_cache_put(key, k_pad)
    px_cidx = _compact_pixels(hit_px, pos_px, k_pad)
    hook("compact", px=px_cidx)
    img = None
    overflow = torch.zeros((), dtype=torch.int64, device=scene.device)
    for s0 in range(0, samples, chunk):
        c = min(chunk, samples - s0)
        hook("round", s0=s0, samples=c)
        part, ov = _trace_compacted_pixels(
            scene, px_cidx, k_dev, width=width, height=height, samples=c,
            cfg=cfg, go_camera=go_camera, split=split, deep_caps=deep_caps,
            offset=s0, sum_image=True, hook=hook)
        img = part if img is None else img + part
        overflow = overflow + ov
    if assume_capacity:
        _defer_check(key, k_dev, k_pad, overflow)
    elif split:
        ov = int(overflow)
        hook("overflow", overflow=ov)
        if ov > 0:
            _SPLIT_BLACKLIST.add(key)
            return render_wavefront_chunked(scene, chunk=chunk, **kw)
    return _finish(img / samples, post, as_numpy)


# The Renderer's engines (raytrace_tpu/renderer.py:842).
ENGINES = ("auto", "kernels", "eager")


def scene_prim_count(scene) -> int:
    """Spheres + triangles + planes (``Scene.prim_count``)."""
    return scene.prim_count


def pick_band_height(width: int, height: int, samples: int,
                     lane_budget: int = 1 << 21, n_prims: int = 1) -> int:
    """Rows of a band of the eager engine (:122): the largest band whose
    lanes stay under the budget, which past 128 primitives also caps the
    (lanes x primitives) product near 2^28."""
    if n_prims > 128:
        lane_budget = min(lane_budget, max(1 << 15, (1 << 28) // n_prims))
    rows = max(1, lane_budget // max(1, width * samples))
    return int(min(rows, height))


class Renderer:
    """Drop-in equivalent of the reference's ParallelRenderer.

    Runs on ``device`` (default CUDA; raises when there is no GPU unless
    ``device="cpu"`` is given) through the main path, ``render_wavefront``,
    in the unroll, bvh, stream and loop modes: every scene, those past the
    JAX package's 262,144-primitive cap in stream mode (up to
    ``megakernel.MAX_STREAM_ROWS``). ``engine`` (``ENGINES``) picks that
    path or the banded dense one. ``render_adaptive`` runs the adaptive
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
        # "auto" and "kernels": the compacted wavefront (the kernels on the
        # card, their plain versions on the CPU; "kernels" raises where
        # megakernel.scene_fits_kernel refuses the scene); "eager": the
        # banded dense path, render_band (the JAX package's "auto" |
        # "pallas" | "jnp")
        self.engine = "auto"
        self.benchmark_data = BenchmarkData()
        self.progress_callback = None  # fn(done_rows, total_rows)
        self.metrics = None  # an obs.MetricsCollector, or None

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

    def _engine(self, scene) -> str:
        """"kernels" (the compacted wavefront) or "eager" (the bands)."""
        if self.engine not in ENGINES:
            raise ValueError(f"engine {self.engine!r} is not one of "
                             f"{ENGINES}")
        if self.engine == "kernels" and not megakernel.scene_fits_kernel(
                scene):
            raise ValueError(
                f"engine 'kernels': the scene's {scene.prim_count} "
                "primitives fit no kernel mode of the JAX package "
                "(megakernel.scene_fits_kernel); use engine 'auto', which "
                "renders it in stream mode, or 'eager'")
        return "eager" if self.engine == "eager" else "kernels"

    def render_linear_device(self, scene, width: int, height: int,
                             band_h: Optional[int] = None) -> torch.Tensor:
        """(H,W,3) mean linear radiance as a tensor on the device, by the
        Renderer's engine: the compacted wavefront (``render_wavefront``
        at the validated capacity) in one piece, or the dense path in row
        bands of ``band_h`` rows (``pick_band_height`` by default; a
        ragged last band renders at full height and keeps its new rows,
        as raytrace_tpu/renderer.py:947-955 does). ``progress_callback``
        is called after each band (once, with (H, H), on the wavefront),
        and ``metrics`` records the pixels and the camera rays."""
        scene = scene.to(self.device)
        cfg = self.trace_config()
        engine = self._engine(scene)
        m = self.metrics
        if m is not None:
            m.start(total_pixels=width * height)
        if engine == "kernels":
            out = render_wavefront(scene, width=width, height=height,
                                   samples=self.samples, cfg=cfg,
                                   go_camera=self.go_camera)
            bands = [(0, height)]
        else:
            bh = band_h or pick_band_height(width, height, self.samples,
                                            n_prims=scene.prim_count)
            bh = min(bh, height)
            out = torch.empty((height, width, 3), dtype=torch.float32,
                              device=scene.device)
            bands = []
            for y0 in range(0, height, bh):
                top = min(y0, height - bh)
                out[top:top + bh] = render_band(
                    scene, top, width=width, height=height, band_h=bh,
                    samples=self.samples, cfg=cfg, go_camera=self.go_camera)
                bands.append((y0, min(bh, height - y0)))
        for y0, rows in bands:
            if self.progress_callback is not None:
                self.progress_callback(y0 + rows, height)
            if m is not None:
                m.record_pixels(rows * width)
                m.record_rays(rows * width * self.samples)
        if m is not None:
            m.record_job_complete()
        return out

    def render_linear(self, scene, width: int, height: int,
                      band_h: Optional[int] = None) -> np.ndarray:
        """(H,W,3) float32 numpy mean linear radiance."""
        return self.render_linear_device(scene, width, height,
                                         band_h).cpu().numpy()

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
