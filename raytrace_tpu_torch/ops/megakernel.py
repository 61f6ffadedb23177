"""The two kernels of the main path, each beside its plain PyTorch version.

Port of the host side of ``raytrace_tpu/ops/megakernel.py``:

* K1, ``trace_unroll`` - the bounce megakernel (``trace_pallas`` :2987 in
  ``unroll`` mode). CUDA source: ``csrc/trace_unroll.cu``. Plain version:
  ``trace.trace``.
* K2, ``pixel_mask`` - the per-pixel conservative hit mask
  (``pixel_mask_pallas`` :2532, brute-force branch). CUDA source:
  ``csrc/pixel_mask.cu``. Plain version: ``pixel_mask_plain``.

A wrapper takes its plain version only for a scene or tensor on the CPU;
on a CUDA device it launches its kernel or raises - there is no fallback.
Each wrapper counts its launches in ``LAUNCHES``, adding one where it
launches its kernel and nowhere else.

Scenes past 96 primitives (the JAX package's ``bvh``, ``stream`` and
``loop`` modes) are not in this slice of the port and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace as trace_mod
from .._f32 import sqrt as _sqrt
from ..camera import lookat_basis
from . import _build

UNROLL_PRIM_LIMIT = 96
MAX_DEPTH = 64            # RT_MAX_DEPTH in csrc/trace_unroll.cu
MAX_LIGHTS = 16           # RT_MAX_LIGHTS
MAX_SHADOW_SAMPLES = 64   # RT_MAX_SHADOW_SAMPLES
COUNTERS = 5              # rt::kCounters: per-lane work counters of K1
ORDER = ("sph", "tri", "pln", "box", "lit", "mat")  # K1's table layout

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"trace_unroll": 0, "pixel_mask": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel_mode(scene) -> str:
    """'unroll' | 'bvh' | 'stream' | 'loop' by primitive count, as in the
    JAX package (bvh/stream need an accel, which this port cannot build
    yet, so large scenes report 'loop')."""
    return "unroll" if scene.prim_count <= UNROLL_PRIM_LIMIT else "loop"


def _require_unroll(scene) -> None:
    if _kernel_mode(scene) != "unroll":
        raise NotImplementedError(
            f"scene has {scene.prim_count} primitives; scenes past "
            f"{UNROLL_PRIM_LIMIT} (BVH, stream and loop modes, K3-K7) are "
            "not ported yet: ROADMAP Queue 2")


def pack_tables(scene):
    """Row-major float32 tables of the kernels (one row per item):
    sph (Ns,5), tri (Nt_hit,13), pln (Np,7), box (Nb,7), lit (L,7),
    mat (M,14). ``tri`` holds the hit triangles only: cube faces are hit
    as their boxes. Column layouts are those of ``csrc/trace_unroll.cu``."""
    g, m, lt = scene.geometry, scene.materials, scene.lights
    nt = g.n_hit_tris
    v0 = g.tri_v0[:nt]
    f = lambda x: x.to(torch.float32)
    col = lambda x: f(x)[:, None]
    return dict(
        sph=torch.cat([g.sph_center, g.sph_radius[:, None],
                       col(g.sph_mat)], 1),
        tri=torch.cat([v0, g.tri_v1[:nt] - v0, g.tri_v2[:nt] - v0,
                       g.tri_normal[:nt], col(g.tri_mat[:nt])], 1),
        pln=torch.cat([g.pl_point, g.pl_normal, col(g.pl_mat)], 1),
        box=torch.cat([g.box_min, g.box_max, col(g.box_mat)], 1),
        lit=torch.cat([lt.position, lt.color, lt.intensity[:, None]], 1),
        mat=torch.cat([col(m.kind), m.albedo, m.roughness[:, None],
                       m.metallic[:, None], m.specular[:, None],
                       m.ior[:, None], m.emit, m.eff_albedo], 1),
    )


def _affine_camera(scene, go_camera: bool) -> torch.Tensor:
    """(4,3) [origin, A, B, C]: direction = A + u*B + v*C (both cameras
    are affine in u, v)."""
    cam = scene.camera
    if go_camera:
        vp_w = 2.0 * cam.aspect_ratio
        zero = torch.zeros_like(vp_w)
        B = torch.stack([vp_w, zero, zero])
        C = torch.tensor([0.0, 2.0, 0.0], device=vp_w.device)
        A = -B / 2.0 - C / 2.0 - torch.tensor([0.0, 0.0, 1.0],
                                              device=vp_w.device)
    else:
        fwd, right, up, half_w, half_h = lookat_basis(cam)
        A = fwd - half_w * right - half_h * up
        B = 2.0 * half_w * right
        C = 2.0 * half_h * up
    return torch.stack([cam.position, A, B, C]).to(torch.float32)


def _bsphere_table(scene) -> torch.Tensor:
    """(Ns+Nt, 4) [center.xyz, radius]: the spheres, then every triangle's
    bounding sphere (centroid, farthest vertex) - cube faces included,
    which is how the mask covers boxes."""
    g = scene.geometry
    m = (g.tri_v0 + g.tri_v1 + g.tri_v2) * (1.0 / 3.0)

    def sq(v):
        dv = v - m
        return dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1] + dv[:, 2] * dv[:, 2]

    rt = _sqrt(torch.maximum(torch.maximum(sq(g.tri_v0), sq(g.tri_v1)),
                             sq(g.tri_v2)))
    c = torch.cat([g.sph_center, m], 0)
    r = torch.cat([g.sph_radius, rt], 0)
    return torch.cat([c, r[:, None]], 1)


def _cone_half_sin(cam4: torch.Tensor, width: int,
                   height: int) -> torch.Tensor:
    """Bound on sin(angle) between any jittered ray of a pixel and its
    center ray: 0.5 * (|B|/W + |C|/H), as a float32 scalar tensor."""
    b, c = cam4[2], cam4[3]
    nb = _sqrt(b[0] * b[0] + b[1] * b[1] + b[2] * b[2])
    nc = _sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])
    return 0.5 * (nb / width + nc / height)


def _mask_inputs(scene, width, height, cfg, go_camera):
    if cfg.depth_of_field:
        raise NotImplementedError(
            "the mask's thin-lens DoF slack is not ported yet (and the "
            "JAX kernel's is not conservative): ROADMAP Queue 1 item 3 and "
            "Queue 3")
    _require_unroll(scene)
    cam4 = _affine_camera(scene, go_camera)
    k = _cone_half_sin(cam4, width, height)
    g = scene.geometry
    pln = torch.cat([g.pl_point, g.pl_normal,
                     g.pl_mat[:, None].to(torch.float32)], 1)
    return cam4, k, _bsphere_table(scene), pln


# ---------------------------------------------------------------- K2 ----

def pixel_mask_plain(scene, *, width: int, height: int, cfg,
                     go_camera: bool = True) -> torch.Tensor:
    """K2's plain version: (H*W,) bool, the same float32 operations as
    ``csrc/pixel_mask.cu`` vectorised over (pixels, primitives)."""
    cam4, k, bs, pln = _mask_inputs(scene, width, height, cfg, go_camera)
    dev = scene.device
    eps = 1e-3
    inv_w = float(np.float32(1.0 / width))
    inv_h = float(np.float32(1.0 / height))
    pix = torch.arange(width * height, device=dev)
    u = ((pix % width).to(torch.float32) + 0.5) * inv_w
    v = ((pix // width).to(torch.float32) + 0.5) * inv_h
    o = cam4[0]
    d = cam4[1] + u[:, None] * cam4[2] + v[:, None] * cam4[3]   # (P,3)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    sqa = _sqrt(a)
    hit = torch.zeros((width * height,), dtype=torch.bool, device=dev)
    if bs.shape[0]:
        oc = bs[None, :, :3] - o
        ocx, ocy, ocz = oc[..., 0], oc[..., 1], oc[..., 2]
        oc2 = ocx * ocx + ocy * ocy + ocz * ocz
        g = ocx * dx + ocy * dy + ocz * dz
        r = bs[None, :, 3]
        R = r + (_sqrt(oc2) + r) * k + eps
        hit |= torch.any((oc2 - g * g * inv_a <= R * R) & (g >= -R * sqa),
                         dim=-1)
    if pln.shape[0]:
        n = pln[None, :, 3:6]
        denom = dx * n[..., 0] + dy * n[..., 1] + dz * n[..., 2]
        pd = pln[None, :, 0:3] - o
        num = (pd[..., 0] * n[..., 0] + pd[..., 1] * n[..., 1]
               + pd[..., 2] * n[..., 2])
        hit |= torch.any((torch.abs(denom) <= k + eps) | (num * denom > 0.0)
                         | (torch.abs(num) <= eps), dim=-1)
    return hit


def prepare_pixel_mask(scene, *, width: int, height: int, cfg,
                       go_camera: bool = True):
    """K2's inputs on the card: returns (out, launch). ``launch()`` runs
    the kernel into ``out``, (H*W,) bool, and counts the launch."""
    dev = scene.device
    if dev.type != "cuda":
        raise RuntimeError(f"pixel_mask kernel: device {dev} is not CUDA")
    cam4, k, bs, pln = _mask_inputs(scene, width, height, cfg, go_camera)
    cam = torch.cat([cam4.reshape(-1), k.reshape(1)]).contiguous()
    bs = bs.contiguous()
    pln = pln.contiguous()
    out = torch.empty((width * height,), dtype=torch.bool, device=dev)
    lib = _build.library()
    inv_w = float(np.float32(1.0 / width))
    inv_h = float(np.float32(1.0 / height))

    def launch():
        err = lib.rt_pixel_mask(
            out.data_ptr(), width, height, inv_w, inv_h, cam.data_ptr(),
            bs.data_ptr(), bs.shape[0], pln.data_ptr(), pln.shape[0],
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "pixel_mask")
        LAUNCHES["pixel_mask"] += 1

    return out, launch


def pixel_mask(scene, *, width: int, height: int, cfg,
               go_camera: bool = True) -> torch.Tensor:
    """(H*W,) bool conservative per-pixel hit mask on the scene's device:
    K2 on CUDA, its plain version on the CPU."""
    if scene.device.type == "cpu":
        return pixel_mask_plain(scene, width=width, height=height, cfg=cfg,
                                go_camera=go_camera)
    out, launch = prepare_pixel_mask(scene, width=width, height=height,
                                     cfg=cfg, go_camera=go_camera)
    launch()
    return out


# ---------------------------------------------------------------- K1 ----

def _check_trace_inputs(scene, origin, direction, pix_id, samp_id, cfg):
    trace_mod.check_supported(cfg)
    _require_unroll(scene)
    n = origin.shape[0]
    for name, t, shape in (("origin", origin, (n, 3)),
                           ("direction", direction, (n, 3)),
                           ("pix_id", pix_id, (n,)),
                           ("samp_id", samp_id, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.device != scene.device:
            raise ValueError(f"{name} is on {t.device}, the scene on "
                             f"{scene.device}")
    if not (0 < cfg.max_depth <= MAX_DEPTH):
        raise ValueError(f"max_depth must be in [1, {MAX_DEPTH}]")
    if not (0 < cfg.shadow_samples <= MAX_SHADOW_SAMPLES):
        raise ValueError(f"shadow_samples must be in [1, "
                         f"{MAX_SHADOW_SAMPLES}]")
    if scene.lights.position.shape[0] > MAX_LIGHTS:
        raise NotImplementedError(f"more than {MAX_LIGHTS} lights")
    if scene.materials.kind.numel() and int(scene.materials.kind.max()) > 6:
        raise NotImplementedError("extended material kinds (7-12): ROADMAP "
                                  "Queue 1 item 2")


def prepare_trace_unroll(scene, origin, direction, pix_id, samp_id, cfg,
                         *, counters: torch.Tensor | None = None):
    """K1's inputs on the card: returns (out, launch). ``launch()`` runs
    the kernel into ``out``, (B,3) float32 radiance, and counts the
    launch. ``counters``, a (B, COUNTERS) int32 tensor, receives each
    lane's work: closest-hit rays, hard and soft shadow rays, and
    occlusion tests of spheres+planes and of triangles+boxes (for
    operation counts; off on the main path)."""
    dev = scene.device
    if dev.type != "cuda":
        raise RuntimeError(f"trace_unroll kernel: device {dev} is not CUDA")
    _check_trace_inputs(scene, origin, direction, pix_id, samp_id, cfg)
    n = origin.shape[0]
    o = origin.to(torch.float32).contiguous()
    d = direction.to(torch.float32).contiguous()
    pix = pix_id.to(torch.int32).contiguous()
    samp = samp_id.to(torch.int32).contiguous()
    tabs = pack_tables(scene)
    counts = [tabs[k].shape[0] for k in ORDER]
    flat = torch.cat([tabs[k].reshape(-1) for k in ORDER]).contiguous()
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    cptr = None
    if counters is not None:
        if (tuple(counters.shape) != (n, COUNTERS)
                or counters.dtype != torch.int32 or counters.device != dev
                or not counters.is_contiguous()):
            raise ValueError(f"counters must be a contiguous (B,{COUNTERS}) "
                             "int32 tensor on the scene's device")
        cptr = counters.data_ptr()
    lib = _build.library()

    def launch():
        err = lib.rt_trace_unroll(
            o.data_ptr(), d.data_ptr(), pix.data_ptr(), samp.data_ptr(),
            out.data_ptr(), cptr, n, flat.data_ptr(), *counts,
            cfg.max_depth, cfg.shadow_samples, int(cfg.soft_shadows),
            int(cfg.recursive_reflections), cfg.seed & 0xFFFFFFFF,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "trace_unroll")
        LAUNCHES["trace_unroll"] += 1

    return out, launch


def trace_unroll(scene, origin, direction, pix_id, samp_id,
                 cfg) -> torch.Tensor:
    """Trace lanes to completion: radiance (B,3) float32.

    K1 on CUDA, ``trace.trace`` on the CPU. origin/direction: (B,3)
    float32; pix_id/samp_id: (B,) integer lane ids (uint32 values).
    """
    if scene.device.type == "cpu":
        return trace_mod.trace(scene, origin, direction, pix_id, samp_id,
                               cfg)
    out, launch = prepare_trace_unroll(scene, origin, direction, pix_id,
                                       samp_id, cfg)
    launch()
    return out
