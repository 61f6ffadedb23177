"""Sky and atmosphere (port of ``raytrace_tpu/atmosphere.py``).

The reference's internal/atmosphere never compiled; the JAX package made
its recipe work and this module carries it over as torch ops: a vertical
sky gradient, a scattering-colour lerp by exp(-|y| * depth), a sun disk
with a pow-1.5 edge falloff, time-of-day darkening, an optional fog lerp
and the reference's clamp to [0.1, 0.98]; the Rayleigh and
Henyey-Greenstein phase functions that the volumetric raymarch of
``effects.py`` uses; and the compositing of the sky into the miss pixels
of a rendered image. Colours are (..., 3) linear float32 tensors; every
function works on the device of its input.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from . import camera as cam_mod
from ._f32 import sqrt as _sqrt
from .ops import intersect


@dataclasses.dataclass(frozen=True)
class AtmosphereSettings:
    """Preset parameters (atmosphere.go:18-26 struct fields)."""

    horizon_color: tuple = (0.8, 0.85, 0.95)
    zenith_color: tuple = (0.35, 0.55, 0.95)
    scattering_color: tuple = (0.7, 0.8, 1.0)
    sun_direction: tuple = (0.3, 0.8, 0.5)
    sun_color: tuple = (1.0, 0.95, 0.8)
    sun_intensity: float = 1.0
    sun_size: float = 0.04
    atmosphere_depth: float = 1.2
    time_of_day: float = 1.0   # 1 = noon, 0 = night
    fog_color: tuple = (0.75, 0.78, 0.82)
    fog_amount: float = 0.0


def presets() -> Dict[str, AtmosphereSettings]:
    """Default/White/Sunset/Night (atmosphere.go:28-98)."""
    return {
        "default": AtmosphereSettings(),
        "white": AtmosphereSettings(
            horizon_color=(0.95, 0.95, 0.95),
            zenith_color=(0.85, 0.85, 0.9),
            scattering_color=(0.9, 0.9, 0.95),
            sun_intensity=0.8),
        "sunset": AtmosphereSettings(
            horizon_color=(0.98, 0.55, 0.3),
            zenith_color=(0.3, 0.25, 0.5),
            scattering_color=(0.95, 0.6, 0.4),
            sun_direction=(0.7, 0.12, 0.3),
            sun_color=(1.0, 0.6, 0.3),
            sun_size=0.08, time_of_day=0.35),
        "night": AtmosphereSettings(
            horizon_color=(0.08, 0.1, 0.18),
            zenith_color=(0.01, 0.015, 0.05),
            scattering_color=(0.1, 0.12, 0.25),
            sun_color=(0.8, 0.85, 1.0),
            sun_intensity=0.15, sun_size=0.015, time_of_day=0.05),
    }


def _vec(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """v / |v| along the last axis, 0 where |v| = 0."""
    n = _sqrt((v * v).sum(-1, keepdim=True))
    return torch.where(n > 0, v / torch.where(n > 0, n, torch.ones_like(n)),
                       torch.zeros_like(v))


def get_sky_color(direction: torch.Tensor,
                  settings: AtmosphereSettings) -> torch.Tensor:
    """GetSkyColor (atmosphere.go:100-135) for (..., 3) ray directions (not
    necessarily normalised): (..., 3) colours clamped to [0.1, 0.98] (the
    reference's final clamp, atmosphere.go:133-134)."""
    dev = direction.device
    d = _norm(direction.to(torch.float32))
    y = torch.clamp(d[..., 1], -1.0, 1.0)
    horizon = _vec(settings.horizon_color, dev)
    zenith = _vec(settings.zenith_color, dev)
    scat = _vec(settings.scattering_color, dev)
    sun_c = _vec(settings.sun_color, dev)
    sun_d = _norm(_vec(settings.sun_direction, dev))

    # vertical gradient: horizon at y = 0, zenith at y = 1
    t = torch.clamp(y, 0.0, 1.0)[..., None]
    sky = horizon + (zenith - horizon) * t
    # scattering lerp by exp(-|y| * depth)
    s = torch.exp(-torch.abs(y) * settings.atmosphere_depth)[..., None]
    sky = sky + (scat - sky) * s * 0.5
    # sun disk with a pow-1.5 edge falloff
    cos_sun = (d * sun_d).sum(-1)
    edge = torch.clamp((cos_sun - (1.0 - settings.sun_size))
                       / settings.sun_size, 0.0, 1.0)
    sky = sky + sun_c * (torch.pow(edge, 1.5)[..., None]
                         * settings.sun_intensity)
    # time-of-day darkening
    sky = sky * (0.15 + 0.85 * settings.time_of_day)
    if settings.fog_amount > 0.0:
        fog = _vec(settings.fog_color, dev)
        sky = sky + (fog - sky) * settings.fog_amount
    return torch.clamp(sky, 0.1, 0.98)


def atmospheric_attenuation(distance: torch.Tensor) -> torch.Tensor:
    """GetAtmosphericAttenuation (atmosphere.go:137-143):
    exp(-0.1 d) * exp(-0.05 d)."""
    d = distance.to(torch.float32)
    return torch.exp(-0.1 * d) * torch.exp(-0.05 * d)


def rayleigh_phase(cos_theta: torch.Tensor) -> torch.Tensor:
    """3/(16 pi) (1 + cos^2) (atmospheric_effects.go:49-55)."""
    c = cos_theta.to(torch.float32)
    return float(np.float32(3.0 / (16.0 * math.pi))) * (1.0 + c * c)


def henyey_greenstein_phase(cos_theta: torch.Tensor,
                            g: float = 0.9) -> torch.Tensor:
    """The Mie phase by Henyey-Greenstein (atmospheric_effects.go:57-69)."""
    c = cos_theta.to(torch.float32)
    g = np.float32(g)
    g2 = g * g
    denom = torch.pow(float(1.0 + g2) - float(2.0 * g) * c, 1.5)
    return (float(np.float32(1.0 / (4.0 * math.pi))) * float(1.0 - g2)
            / torch.clamp(denom, min=1e-8))


def height_density(h: torch.Tensor, scale_height: float = 8000.0):
    """Exponential density falloff with altitude
    (atmospheric_effects.go:71-73)."""
    return torch.exp(-h.to(torch.float32) / scale_height)


def center_rays(scene, width: int, height: int, go_camera: bool = True):
    """(origin (P,3), direction (P,3)) of every pixel's center ray."""
    dev = scene.device
    n_px = width * height
    i = torch.arange(n_px, dtype=torch.float32, device=dev)
    xs = (i % width + 0.5) / width
    ys = (torch.div(i, width, rounding_mode="floor") + 0.5) / height
    rays = cam_mod.go_rays if go_camera else cam_mod.lookat_rays
    return rays(scene.camera, xs, ys)


# (ray, primitive) pairs per brute-force call over center rays: bounds the
# (rays x primitives) temporaries on big scenes.
CENTER_PAIRS = 1 << 26


def center_chunk(scene) -> int:
    """Center rays per call of a brute-force test over the scene's
    primitives (apply_sky_to_image, Renderer._primary_depth)."""
    return max(256, CENTER_PAIRS // max(1, scene.prim_count))


def apply_sky_to_image(scene, linear_img: torch.Tensor, width: int,
                       height: int, settings: AtmosphereSettings,
                       go_camera: bool = True) -> torch.Tensor:
    """Composite the sky into the miss pixels of a linear (H,W,3) image.

    The reference renders a miss black (renderer.go:170-173); with an
    atmosphere block the sky replaces those pixels. A pixel is a miss when
    its CENTER ray hits nothing (brute-force any-hit over every primitive,
    as in the JAX package; in chunks of ``center_chunk`` rays, which
    changes no verdict)."""
    o, d = center_rays(scene, width, height, go_camera)
    step = center_chunk(scene)
    hit = torch.cat([
        intersect.any_hit(scene.geometry, o[i:i + step], d[i:i + step],
                          1e-3, intersect.BIG)
        for i in range(0, o.shape[0], step)])
    sky = get_sky_color(d, settings).reshape(height, width, 3)
    img = linear_img.to(torch.float32)
    return torch.where(hit.reshape(height, width, 1), img, sky)


def settings_from_config(block: Dict) -> AtmosphereSettings:
    """Settings from a scene JSON's 'atmospheric' block (the schema the Go
    loader drops, scene.go:12-16)."""
    base = presets().get(str(block.get("preset", "default")).lower(),
                         AtmosphereSettings())
    fields = {}
    for key, attr in [("horizonColor", "horizon_color"),
                      ("zenithColor", "zenith_color"),
                      ("scatteringColor", "scattering_color"),
                      ("sunDirection", "sun_direction"),
                      ("sunColor", "sun_color")]:
        if key in block:
            fields[attr] = tuple(float(x) for x in block[key])
    for key, attr in [("sunIntensity", "sun_intensity"),
                      ("sunSize", "sun_size"),
                      ("atmosphereDepth", "atmosphere_depth"),
                      ("timeOfDay", "time_of_day"),
                      ("fogAmount", "fog_amount")]:
        if key in block:
            fields[attr] = float(block[key])
    if "fogColor" in block:
        fields["fog_color"] = tuple(float(x) for x in block["fogColor"])
    return dataclasses.replace(base, **fields)
