"""Procedural animated emitters (port of
``raytrace_tpu/effects_spectacular.py``): the reference's ten emitters
(fire, explosion, lightning, aurora, hologram, portal, energy field,
plasma, crystal, nebula), each an emissive colour (..., 3) of a point
tensor (..., 3) and a time, over the value noise of ``fastmath``. They
run on the device of the points.

Use: evaluate at the hit points of an emissive object and add the result
to its emission.
"""

from __future__ import annotations

import math

import torch

from . import fastmath as fm


def _p3(p):
    p = torch.as_tensor(p, dtype=torch.float32)
    return p[..., 0], p[..., 1], p[..., 2]


def _rgb(c, like):
    return torch.tensor(c, dtype=torch.float32, device=like.device)


def _mix(a, b, t):
    """a + (b - a) * t of colours (tuples or tensors) by a weight (...)."""
    a = a if isinstance(a, torch.Tensor) else _rgb(a, t)
    b = b if isinstance(b, torch.Tensor) else _rgb(b, t)
    return a + (b - a) * t[..., None]


def fire(p, t=0.0, intensity: float = 1.0):
    """Rising turbulent flame: hot core, orange, dark red."""
    x, y, z = _p3(p)
    n = fm.fbm_3d(x * 2.0, y * 2.0 - 2.0 * t, z * 2.0, octaves=3)
    heat = torch.clamp(n + 0.6 - 0.5 * torch.clamp(y, 0.0, 2.0), 0.0, 1.0)
    c = _mix(_mix((0.1, 0.0, 0.0), (1.0, 0.35, 0.05), heat),
             (1.0, 0.9, 0.4), torch.clamp(heat - 0.6, 0.0, 0.4) * 2.5)
    return c * (intensity * heat)[..., None]


def explosion(p, t=0.25, intensity: float = 2.0):
    """A shock shell expanding from the origin."""
    x, y, z = _p3(p)
    r = torch.sqrt(x * x + y * y + z * z)
    shell = torch.exp(-12.0 * (r - 2.0 * t) ** 2)
    core = torch.exp(-3.0 * r * r) * max(0.0, 1.0 - 2.0 * t)
    n = fm.fast_noise_3d(x * 4.0, y * 4.0, z * 4.0)
    glow = shell * (0.7 + 0.3 * n) + core
    c = _mix((1.0, 0.4, 0.05), (1.0, 0.95, 0.7), torch.clamp(glow, 0, 1))
    return c * (intensity * glow)[..., None]


def lightning(p, t=0.0, intensity: float = 3.0):
    """A jittering bolt along the y axis."""
    x, y, z = _p3(p)
    wob = fm.fast_noise_2d(y * 3.0, torch.full_like(y, t * 7.0)) - 0.5
    dist = torch.sqrt((x - 0.4 * wob) ** 2 + z * z)
    bolt = torch.exp(-60.0 * dist * dist)
    flicker = 0.7 + 0.3 * torch.sin(torch.tensor(t * 60.0,
                                                 dtype=torch.float32,
                                                 device=x.device))
    return _rgb((0.75, 0.85, 1.0), x) * (intensity * flicker
                                        * bolt)[..., None]


def aurora(p, t=0.0, intensity: float = 0.8):
    """Green to violet curtains drifting with time."""
    x, y, z = _p3(p)
    band = torch.sin(x * 1.5 + fm.fast_noise_2d(x, torch.full_like(x, t))
                     * 4.0 + z)
    strength = torch.clamp(band, 0.0, 1.0) * torch.exp(
        -0.3 * torch.abs(y - 3.0))
    c = _mix((0.05, 0.8, 0.35), (0.5, 0.2, 0.8),
             torch.clamp(y * 0.2, 0.0, 1.0))
    return c * (intensity * strength)[..., None]


def hologram(p, t=0.0, intensity: float = 1.0):
    """Cyan scanlines with a glitch flicker."""
    x, y, z = _p3(p)
    scan = 0.5 + 0.5 * torch.sin(y * 40.0 - t * 10.0)
    glitch = torch.where(fm.fast_noise_1d(torch.full_like(y, t * 13.0))
                         > 0.9, 0.2, 1.0)
    return _rgb((0.2, 0.9, 1.0), x) * (intensity * scan * glitch)[..., None]


def portal(p, t=0.0, intensity: float = 1.5):
    """A swirling ring in the x-y plane."""
    x, y, z = _p3(p)
    r = torch.sqrt(x * x + y * y)
    swirl = 0.5 + 0.5 * torch.sin(torch.atan2(y, x) * 5.0 + r * 8.0
                                  - t * 4.0)
    ring = torch.exp(-20.0 * (r - 1.0) ** 2) * torch.exp(-4.0 * z * z)
    c = _mix((0.4, 0.1, 0.9), (0.1, 0.7, 1.0), swirl)
    return c * (intensity * ring * swirl)[..., None]


def energy_field(p, t=0.0, intensity: float = 0.9):
    """A pulsing shell on the unit sphere."""
    x, y, z = _p3(p)
    r = torch.sqrt(x * x + y * y + z * z)
    pulse = 0.6 + 0.4 * torch.sin(t * 6.0 + r * 10.0)
    shell = torch.exp(-30.0 * (r - 1.0) ** 2)
    hex_n = fm.fast_noise_3d(x * 6.0, y * 6.0, z * 6.0)
    return _rgb((0.2, 0.6, 1.0), x) * (
        intensity * shell * pulse * (0.6 + 0.4 * hex_n))[..., None]


def plasma(p, t=0.0, intensity: float = 1.0):
    """Three-band interference plasma."""
    x, y, z = _p3(p)
    v = (torch.sin(x * 3.0 + t) + torch.sin((y + z) * 2.0 - t)
         + torch.sin(torch.sqrt(x * x + y * y + 1.0) * 4.0)) / 3.0
    r = 0.5 + 0.5 * torch.sin(math.pi * v)
    g = 0.5 + 0.5 * torch.sin(math.pi * v + 2.0 * math.pi / 3.0)
    b = 0.5 + 0.5 * torch.sin(math.pi * v + 4.0 * math.pi / 3.0)
    return torch.stack([r, g, b], dim=-1) * intensity


def crystal(p, t=0.0, intensity: float = 0.8):
    """Faceted sparkle from quantised positions."""
    x, y, z = _p3(p)
    fx, fy, fz = (torch.floor(c * 4.0) / 4.0 for c in (x, y, z))
    facet = fm.fast_noise_3d(fx * 50.0, fy * 50.0, fz * 50.0)
    sparkle = torch.pow(facet, 8.0) * (2.0 + torch.sin(t * 3.0
                                                       + facet * 20.0))
    c = _mix((0.6, 0.8, 1.0), (1.0, 1.0, 1.0), torch.clamp(sparkle, 0, 1))
    return c * (intensity * (0.2 + sparkle))[..., None]


def nebula(p, t=0.0, intensity: float = 0.6):
    """Many-coloured fbm gas clouds."""
    x, y, z = _p3(p)
    d1 = fm.fbm_3d(x, y, z + 0.1 * t, octaves=4)
    d2 = fm.fbm_3d(x * 1.7 + 5.0, y * 1.7, z * 1.7, octaves=4)
    c = _mix(_mix((0.05, 0.02, 0.1), (0.6, 0.2, 0.5), d1),
             (0.2, 0.4, 0.9), d2 * 0.6)
    return c * (intensity * (d1 * 0.7 + d2 * 0.3))[..., None]


ALL_EFFECTS = {
    "fire": fire, "explosion": explosion, "lightning": lightning,
    "aurora": aurora, "hologram": hologram, "portal": portal,
    "energyField": energy_field, "plasma": plasma, "crystal": crystal,
    "nebula": nebula,
}
