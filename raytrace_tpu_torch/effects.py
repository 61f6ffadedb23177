"""Atmospheric and post-processing effects (port of
``raytrace_tpu/effects.py``).

The reference's internal/effects were dead code; the JAX package made each
a real image-space pass (or, for the volumetric light, a raymarch over the
scene's lights) driven by the scene-JSON blocks that the Go loader drops.
Here they are plain torch ops on the image's device: the JAX package
computes them with jnp outside any Pallas kernel, so no hand-written
kernel stands behind them. Image inputs and outputs are (H, W, 3) LINEAR
float32 tensors (applied before tone mapping) unless a docstring says
otherwise.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import atmosphere as atmo_mod
from ._f32 import sqrt as _sqrt


def _f(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# -------------------------------------------------------------------- fog --

def fog_factor(distance, mode: str = "exp", density: float = 0.02,
               start: float = 0.0, end: float = 100.0) -> torch.Tensor:
    """linear / exp / exp2 fog factor in [0, 1] (0 = full fog)
    (atmospheric_effects.go:130-176)."""
    d = _f(distance)
    if mode == "linear":
        f = (end - d) / max(end - start, 1e-8)
    elif mode == "exp":
        f = torch.exp(-density * d)
    elif mode == "exp2":
        f = torch.exp(-(density * d) ** 2)
    else:
        raise ValueError(f"unknown fog mode {mode!r}")
    return torch.clamp(f, 0.0, 1.0)


def apply_fog(color, distance, fog_color=(0.75, 0.78, 0.82),
              mode: str = "exp", density: float = 0.02, start: float = 0.0,
              end: float = 100.0) -> torch.Tensor:
    """lerp(fog_color, color, factor) per pixel or lane."""
    color = _f(color)
    f = fog_factor(distance, mode, density, start, end)[..., None]
    fc = _f(fog_color, color.device)
    return fc + (color - fc) * f


# ------------------------------------------------------ volumetric light --

def volumetric_light(origin, direction, max_dist, lights, *, steps: int = 64,
                     density: float = 0.02, scattering: float = 0.5,
                     g: float = 0.76) -> torch.Tensor:
    """In-scattered radiance along rays, accumulated front to back
    (atmospheric_effects.go:75-128): (B,3).

    origin/direction (B,3), max_dist (B,) the march length, lights the
    scene's Lights. At each of ``steps`` samples the transmittance is
    multiplied by exp(-density*dt), and HG-phase * light / d^2 *
    transmittance is added. A Python loop over the steps takes the place of
    the JAX package's fori_loop."""
    o = _f(origin)
    d = _f(direction)
    dn = _sqrt((d * d).sum(-1, keepdim=True))
    d = d / torch.clamp(dn, min=1e-8)
    md = _f(max_dist, o.device)
    dt = md / steps  # (B,)
    acc = torch.zeros_like(o)
    trans = torch.ones(o.shape[:-1], dtype=torch.float32, device=o.device)
    n_lights = lights.position.shape[0]
    step_trans = torch.exp(-density * dt)
    for i in range(steps):
        t = (i + 0.5) * dt
        p = o + d * t[..., None]
        contrib = torch.zeros_like(acc)
        for li in range(n_lights):
            lc = lights.color[li] * lights.intensity[li]
            to_l = lights.position[li] - p
            dist2 = (to_l * to_l).sum(-1)
            ldir = to_l / _sqrt(torch.clamp(dist2, min=1e-8))[..., None]
            cos_t = (d * ldir).sum(-1)
            phase = atmo_mod.henyey_greenstein_phase(cos_t, g)
            contrib = contrib + lc * (phase / torch.clamp(dist2, min=1e-4)
                                      )[..., None]
        acc = acc + contrib * (scattering * density * dt)[..., None] \
            * trans[..., None]
        trans = trans * step_trans
    return acc


# ---------------------------------------------------- image-space passes --

def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur, reflect-padded (a sum of shifted copies,
    as in the JAX package, in the same order)."""
    radius = max(1, int(3 * sigma))
    k = _gaussian_kernel1d(sigma, radius)

    def conv_axis(x, axis):
        n = x.shape[axis]
        # numpy's "reflect" padding (the edge is not repeated; past the
        # far edge it reflects again): index j maps with period 2(n - 1)
        j = np.abs(np.arange(-radius, n + radius))
        if n > 1:
            j = j % (2 * (n - 1))
            j = np.where(j >= n, 2 * (n - 1) - j, j)
        else:
            j = np.zeros_like(j)
        xp = x.index_select(axis, torch.as_tensor(j, device=x.device))
        out = torch.zeros_like(x)
        for i in range(2 * radius + 1):
            out = out + float(k[i]) * xp.narrow(axis, i, n)
        return out

    return conv_axis(conv_axis(img, 0), 1)


def bloom(img, threshold: float = 1.0, intensity: float = 0.5,
          sigma: float = 4.0) -> torch.Tensor:
    """Luminance-threshold bloom (atmospheric_effects.go:291-324)."""
    img = _f(img)
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    bright = torch.where((lum > threshold)[..., None], img,
                         torch.zeros_like(img))
    return img + intensity * _blur(bright, sigma)


def vignette(img, strength: float = 0.5, radius: float = 0.75,
             softness: float = 0.45) -> torch.Tensor:
    """Radial darkening (atmospheric_effects.go:358-391)."""
    img = _f(img)
    h, w = img.shape[:2]
    yy = (torch.arange(h, dtype=torch.float32, device=img.device) / h
          - 0.5) * 2.0
    xx = (torch.arange(w, dtype=torch.float32, device=img.device) / w
          - 0.5) * 2.0
    r = _sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
    t = torch.clamp((r - radius) / max(softness, 1e-6), 0.0, 1.0)
    fade = 1.0 - strength * t * t * (3.0 - 2.0 * t)
    return img * fade[..., None]


def chromatic_aberration(img, strength: float = 2.0) -> torch.Tensor:
    """Radial RGB channel offset (atmospheric_effects.go:326-356; the
    reference's math was a no-op, this one shifts the red and blue
    channels by ``strength`` pixels, rounded, in opposite directions)."""
    img = _f(img)

    def shifted(channel, scale):
        sx = int(round(scale))
        return channel if sx == 0 else torch.roll(channel, sx, dims=1)

    r = shifted(img[..., 0], +strength)
    b = shifted(img[..., 2], -strength)
    return torch.stack([r, img[..., 1], b], dim=-1)


def motion_blur(frames: Sequence) -> torch.Tensor:
    """The mean of sub-frame renders (atmospheric_effects.go:178-199)."""
    return torch.stack([_f(f) for f in frames]).mean(0)


def depth_of_field_blur(img, depth, focal_distance: float = 5.0,
                        aperture: float = 0.1,
                        max_sigma: float = 6.0) -> torch.Tensor:
    """Post-process depth of field: a blend of the image and its blur by
    the per-pixel circle of confusion (atmospheric_effects.go:201-236).
    depth: (H,W) hit distances (BIG on a miss)."""
    img = _f(img)
    depth = _f(depth, img.device)
    coc = torch.clamp(torch.abs(depth - focal_distance) / focal_distance
                      * aperture * 50.0, 0.0, 1.0)
    blurred = _blur(img, max_sigma * 0.5)
    return img + (blurred - img) * coc[..., None]


def lens_flare(img, light_screen_xy, intensity: float = 0.3,
               n_ghosts: int = 4) -> torch.Tensor:
    """Ghost sprites along the light-to-center axis
    (atmospheric_effects.go:238-289)."""
    img = _f(img)
    h, w = img.shape[:2]
    lx, ly = light_screen_xy
    cx, cy = 0.5, 0.5
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] / h
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] / w
    out = img
    for i in range(1, n_ghosts + 1):
        t = i / (n_ghosts + 1.0)
        gx = lx + (cx - lx) * 2.0 * t
        gy = ly + (cy - ly) * 2.0 * t
        r2 = (xx - gx) ** 2 + (yy - gy) ** 2
        size = 0.02 + 0.02 * i
        glow = torch.exp(-r2 / (size * size)) * (intensity / i)
        tint = _f([1.0, 0.9 - 0.1 * i % 0.5, 0.8 - 0.05 * i], img.device)
        out = out + glow[..., None] * tint
    return out


# --------------------------------------------- per-hit renderer helpers --

def caustic_approximation(point, normal, lights) -> torch.Tensor:
    """calculateCaustics (advanced.go:80-90): per light, light.Color *
    max(0, normal . dir_to_light). point/normal (B,3); returns (B,3)."""
    point = _f(point)
    normal = _f(normal)
    out = torch.zeros_like(point)
    for li in range(lights.position.shape[0]):
        to_l = lights.position[li] - point
        n = _sqrt((to_l * to_l).sum(-1, keepdim=True))
        ldir = torch.where(n > 0, to_l / torch.where(n > 0, n,
                                                     torch.ones_like(n)),
                           torch.zeros_like(to_l))
        inten = torch.clamp((normal * ldir).sum(-1), min=0.0)
        out = out + lights.color[li] * inten[..., None]
    return out


def bump_map_normal(point, normal, bump_scale: float = 0.1) -> torch.Tensor:
    """calculateBumpMapping (advanced.go:114-126): a sine/cosine bump from
    world x/y added to the normal, renormalised; the reference's double
    scale (u = x*10, then sin(u*10)) is kept. (B,3) -> (B,3)."""
    point = _f(point)
    normal = _f(normal)
    u = point[..., 0] * 10.0
    v = point[..., 1] * 10.0
    bump_u = torch.sin(u * 10.0) * bump_scale
    bump_v = torch.cos(v * 10.0) * bump_scale
    n = normal + torch.stack([bump_u, bump_v, torch.zeros_like(bump_u)], -1)
    ln = _sqrt((n * n).sum(-1, keepdim=True))
    return torch.where(ln > 0, n / torch.where(ln > 0, ln,
                                               torch.ones_like(ln)),
                       torch.zeros_like(n))


def procedural_texture_color(point) -> torch.Tensor:
    """calculateProceduralTexture (advanced.go:128-142): a sin/cos
    interference colour from world x/y. (B,3) -> (B,3)."""
    point = _f(point)
    u = point[..., 0] * 10.0
    v = point[..., 1] * 10.0
    noise = torch.sin(u * 20.0) * torch.cos(v * 20.0)
    pattern = torch.sin(u * 50.0) * torch.sin(v * 50.0)
    return torch.stack([(noise + 1.0) / 2.0, (pattern + 1.0) / 2.0,
                        (noise * pattern + 1.0) / 2.0], -1)


# --------------------------------------------------- config-driven pass --

def apply_config_effects(img, cfg_blocks: Dict, depth=None,
                         light_screen_xy=(0.7, 0.3)) -> torch.Tensor:
    """The post-FX blocks of a scene config (``SceneConfig.effects``), in
    the JAX package's order: bloom, depthOfField (with a depth map),
    lensFlare, chromaticAberration, vignette."""
    img = _f(img)
    blk = cfg_blocks.get("bloom") or {}
    if blk.get("enabled"):
        img = bloom(img, threshold=float(blk.get("threshold", 1.0)),
                    intensity=float(blk.get("intensity", 0.5)))
    blk = cfg_blocks.get("depthOfField") or {}
    if blk.get("enabled") and depth is not None:
        img = depth_of_field_blur(
            img, depth, focal_distance=float(blk.get("focalDistance", 5.0)),
            aperture=float(blk.get("aperture", 0.1)))
    blk = cfg_blocks.get("lensFlare") or {}
    if blk.get("enabled"):
        img = lens_flare(img, light_screen_xy,
                         intensity=float(blk.get("intensity", 0.3)))
    blk = cfg_blocks.get("chromaticAberration") or {}
    if blk.get("enabled"):
        img = chromatic_aberration(img,
                                   strength=float(blk.get("strength", 2.0)))
    blk = cfg_blocks.get("vignette") or {}
    if blk.get("enabled"):
        img = vignette(img, strength=float(blk.get("strength", 0.5)),
                       radius=float(blk.get("radius", 0.75)))
    return img
