"""Procedural textures (port of ``raytrace_tpu/models/textures.py``).

Every texture is a deterministic, vectorised field of the hit point:
Marble, Wood, Checkerboard and Gradient give a colour (..., 3); Noise,
PerlinNoise and Voronoi give a scalar field (...) that scales the base
albedo (``textured_albedo``). The float32 operations, and their order,
are those of the JAX package, so the two agree to an ulp of the library
``sin``/``pow``. The lattice value noise and its fbm are this module's own
copy of ``raytrace_tpu/fastmath.py`` (``_hash_to_unit`` ... ``fbm_3d``).

The kernels evaluate the same fields from a texture table
(``texture_rows``; device code in ``csrc/textures.cuh``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import rng
from .._f32 import div as _div
from .._f32 import sqrt as _sqrt

_INV24 = 1.0 / (1 << 24)  # exact in float32


# ------------------------------------------------------------- noise ----

def _hash_to_unit(ix, iy, iz, seed: int) -> torch.Tensor:
    """Lattice hash -> U[0,1): pcg4d of the int32 lattice coordinates
    (as uint32) and the seed, top 24 bits of the first word."""
    s = torch.full_like(ix, seed & 0xFFFFFFFF)
    a, _, _, _ = rng.pcg4d(ix & 0xFFFFFFFF, iy & 0xFFFFFFFF,
                           iz & 0xFFFFFFFF, s)
    return (a >> 8).to(torch.float32) * _INV24


def _smooth(t):
    return t * t * (3.0 - 2.0 * t)


def fast_noise_3d(x, y, z, seed: int = 0) -> torch.Tensor:
    """Smoothed value noise on the integer lattice, in [0, 1)."""
    ix, iy, iz = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - ix, y - iy, z - iz
    # the JAX package's int32 lattice, held in int64 for the hash
    ix, iy, iz = (c.to(torch.int32).to(torch.int64) for c in (ix, iy, iz))

    def corner(dx, dy, dz):
        return _hash_to_unit(ix + dx, iy + dy, iz + dz, seed)

    sx, sy, sz = _smooth(fx), _smooth(fy), _smooth(fz)

    def lerp(a, b, t):
        return a + (b - a) * t

    c00 = lerp(corner(0, 0, 0), corner(1, 0, 0), sx)
    c10 = lerp(corner(0, 1, 0), corner(1, 1, 0), sx)
    c01 = lerp(corner(0, 0, 1), corner(1, 0, 1), sx)
    c11 = lerp(corner(0, 1, 1), corner(1, 1, 1), sx)
    return lerp(lerp(c00, c10, sy), lerp(c01, c11, sy), sz)


def _octaves(octaves: int, lacunarity: float, gain: float):
    """((weight, frequency) per octave, sum of the weights): Python floats
    (float64), rounded to float32 only where they meet a tensor, as in the
    JAX package."""
    amp, freq, norm, out = 1.0, 1.0, 0.0, []
    for _ in range(octaves):
        out.append((amp, freq))
        norm += amp
        amp *= gain
        freq *= lacunarity
    return out, norm


def fbm_3d(x, y, z, octaves: int = 4, lacunarity: float = 2.0,
           gain: float = 0.5, seed: int = 0) -> torch.Tensor:
    """Fractal Brownian motion over fast_noise_3d."""
    total = torch.zeros(torch.broadcast_shapes(x.shape, y.shape, z.shape),
                        dtype=torch.float32, device=x.device)
    weights, norm = _octaves(octaves, lacunarity, gain)
    for o, (amp, freq) in enumerate(weights):
        total = total + amp * fast_noise_3d(x * freq, y * freq, z * freq,
                                            seed=seed + o)
    return _div(total, norm)


# ----------------------------------------------------------- textures ----

def _lerp_color(c1, c2, t):
    c1 = torch.tensor(c1, dtype=torch.float32, device=t.device)
    c2 = torch.tensor(c2, dtype=torch.float32, device=t.device)
    return c1 * (1.0 - t[..., None]) + c2 * t[..., None]


@dataclasses.dataclass(frozen=True)
class NoiseTexture:
    scale: float = 1.0
    octaves: int = 4
    persistence: float = 0.5
    lacunarity: float = 2.0
    amplitude: float = 1.0
    seed: int = 0

    def value(self, p):
        p = p.to(torch.float32) * self.scale
        n = fbm_3d(p[..., 0], p[..., 1], p[..., 2], octaves=self.octaves,
                   gain=self.persistence, lacunarity=self.lacunarity,
                   seed=self.seed)
        return n * self.amplitude


@dataclasses.dataclass(frozen=True)
class MarbleTexture:
    base_color: Tuple[float, float, float] = (0.9, 0.9, 0.85)
    vein_color: Tuple[float, float, float] = (0.3, 0.3, 0.35)
    scale: float = 1.0
    turbulence: float = 0.0
    sharpness: float = 1.0

    def value(self, p):
        p = p.to(torch.float32)
        v = torch.sin(p[..., 0] * self.scale + p[..., 1] * self.scale * 0.5
                      + p[..., 2] * self.scale * 0.25)
        v = (v + 1.0) / 2.0
        v = torch.pow(v, self.sharpness)
        return _lerp_color(self.base_color, self.vein_color, v)


@dataclasses.dataclass(frozen=True)
class WoodTexture:
    base_color: Tuple[float, float, float] = (0.55, 0.35, 0.2)
    ring_color: Tuple[float, float, float] = (0.35, 0.2, 0.1)
    scale: float = 1.0
    turbulence: float = 0.0
    ring_width: float = 0.3

    def value(self, p):
        p = p.to(torch.float32)
        ring = torch.abs(torch.sin(p[..., 0] * self.scale
                                   + p[..., 1] * self.scale * 0.5))
        t = torch.where(ring < self.ring_width, 1.0, 0.0)
        return _lerp_color(self.base_color, self.ring_color, t)


@dataclasses.dataclass(frozen=True)
class CheckerboardTexture:
    color1: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    color2: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    scale: float = 1.0

    def value(self, p):
        p = p.to(torch.float32)
        checker = (torch.floor(p[..., 0] * self.scale)
                   + torch.floor(p[..., 1] * self.scale)
                   + torch.floor(p[..., 2] * self.scale))
        even = torch.remainder(checker, 2.0) == 0.0
        c1 = torch.tensor(self.color1, dtype=torch.float32, device=p.device)
        c2 = torch.tensor(self.color2, dtype=torch.float32, device=p.device)
        return torch.where(even[..., None], c1, c2)


def _unit_direction(direction) -> np.ndarray:
    """The gradient direction normalised on the host in float32 numpy, the
    JAX package's expression."""
    d = np.asarray(direction, np.float32)
    return d / (np.linalg.norm(d) or 1.0)


@dataclasses.dataclass(frozen=True)
class GradientTexture:
    color1: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    color2: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    direction: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    def value(self, p):
        p = p.to(torch.float32)
        d = [float(c) for c in _unit_direction(self.direction)]
        t = (p[..., 0] * d[0] + p[..., 1] * d[1] + p[..., 2] * d[2]
             + 1.0) / 2.0
        return _lerp_color(self.color1, self.color2, t)


@dataclasses.dataclass(frozen=True)
class PerlinNoiseTexture:
    scale: float = 1.0
    octaves: int = 4
    persistence: float = 0.5
    lacunarity: float = 2.0
    seed: int = 0

    def value(self, p):
        p = p.to(torch.float32) * self.scale
        return fbm_3d(p[..., 0], p[..., 1], p[..., 2], octaves=self.octaves,
                      gain=self.persistence, lacunarity=self.lacunarity,
                      seed=self.seed)


EUCLIDEAN, MANHATTAN, CHEBYSHEV = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class VoronoiTexture:
    """Distance to the nearest of ``points`` feature points, a
    deterministic function of (seed, index) in [-1, 1]^3."""

    scale: float = 1.0
    points: int = 16
    distance_type: int = EUCLIDEAN
    seed: int = 0

    def _feature_points(self, device="cpu") -> torch.Tensor:
        idx = torch.arange(self.points, dtype=torch.int64, device=device)
        s = torch.full_like(idx, self.seed & 0xFFFFFFFF)
        a, b, c, _ = rng.pcg4d(idx, s, (idx * 31 + 7) & 0xFFFFFFFF,
                               (s + 1) & 0xFFFFFFFF)
        unit = lambda u: (u >> 8).to(torch.float32) * _INV24
        return torch.stack([unit(a), unit(b), unit(c)], dim=-1) * 2.0 - 1.0

    def value(self, p):
        p = p.to(torch.float32) * self.scale
        diff = p[..., None, :] - self._feature_points(p.device)
        dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
        if self.distance_type == MANHATTAN:
            d = torch.abs(dx) + torch.abs(dy) + torch.abs(dz)
        elif self.distance_type == CHEBYSHEV:
            d = torch.maximum(torch.maximum(torch.abs(dx), torch.abs(dy)),
                              torch.abs(dz))
        else:
            d = _sqrt(dx * dx + dy * dy + dz * dz)
        return torch.amin(d, dim=-1)


def texture_from_dict(data):
    """Scene-JSON texture block -> texture object (the JAX package's
    schema: "checkerboard" | "marble" | "wood" | "gradient" | "noise" |
    "perlin" | "voronoi" with their parameters)."""
    t = str(data.get("type", "checkerboard")).lower()

    def col(key, default):
        v = data.get(key)
        return tuple(float(x) for x in v) if v else default

    if t in ("checkerboard", "checker"):
        return CheckerboardTexture(color1=col("color1", (1.0, 1.0, 1.0)),
                                   color2=col("color2", (0.1, 0.1, 0.1)),
                                   scale=float(data.get("scale", 1.0)))
    if t == "marble":
        return MarbleTexture(
            base_color=col("baseColor", (0.9, 0.9, 0.85)),
            vein_color=col("veinColor", (0.3, 0.3, 0.35)),
            scale=float(data.get("scale", 1.0)),
            turbulence=float(data.get("turbulence", 0.0)),
            sharpness=float(data.get("sharpness", 1.0)))
    if t == "wood":
        return WoodTexture(
            base_color=col("baseColor", (0.55, 0.35, 0.2)),
            ring_color=col("ringColor", (0.35, 0.2, 0.1)),
            scale=float(data.get("scale", 1.0)),
            turbulence=float(data.get("turbulence", 0.0)),
            ring_width=float(data.get("ringWidth", 0.3)))
    if t == "gradient":
        return GradientTexture(color1=col("color1", (0.0, 0.0, 0.0)),
                               color2=col("color2", (1.0, 1.0, 1.0)),
                               direction=col("direction", (0.0, 1.0, 0.0)))
    if t == "noise":
        return NoiseTexture(scale=float(data.get("scale", 1.0)),
                            octaves=int(data.get("octaves", 4)),
                            persistence=float(data.get("persistence", 0.5)),
                            seed=int(data.get("seed", 0)))
    if t in ("perlin", "perlinnoise"):
        return PerlinNoiseTexture(scale=float(data.get("scale", 1.0)),
                                  octaves=int(data.get("octaves", 4)),
                                  persistence=float(
                                      data.get("persistence", 0.5)),
                                  seed=int(data.get("seed", 0)))
    if t == "voronoi":
        dist = {"euclidean": EUCLIDEAN, "manhattan": MANHATTAN,
                "chebyshev": CHEBYSHEV}.get(
                    str(data.get("distance", "euclidean")).lower(),
                    EUCLIDEAN)
        return VoronoiTexture(scale=float(data.get("scale", 1.0)),
                              points=int(data.get("points", 16)),
                              distance_type=dist,
                              seed=int(data.get("seed", 0)))
    raise ValueError(f"unknown texture type {t!r}")


def textured_albedo(texture, points, base_albedo=None):
    """The albedo at hit points: a colour texture replaces it, a scalar
    field scales ``base_albedo`` (ones when None)."""
    val = texture.value(points)
    if val.ndim == points.ndim:  # colour texture
        return val
    base = (torch.ones(3, dtype=torch.float32, device=points.device)
            if base_albedo is None else base_albedo)
    return base * val[..., None]


# ------------------------------------------------- the kernels' table ----

TEX_COLS = 16  # floats per binding row of the kernels' texture table
TEX_TYPE = {CheckerboardTexture: 0, MarbleTexture: 1, WoodTexture: 2,
            GradientTexture: 3, NoiseTexture: 4, PerlinNoiseTexture: 5,
            VoronoiTexture: 6}


def _seed_f(seed: int) -> float:
    if not -(1 << 24) < seed < (1 << 24):
        raise ValueError(f"texture seed {seed} is not exact in float32")
    return float(seed)


def texture_rows(bindings):
    """The kernels' texture table from ((material index, texture), ...):
    (rows (N, TEX_COLS), aux (A, 3)) float32, in the layout of
    ``csrc/textures.cuh``. The aux rows hold what the host computes for
    the kernels by the plain version's own functions: the fbm octaves'
    (weight, frequency) and the Voronoi feature points."""
    rows, aux, n_aux = [], [], 0
    for mi, tex in bindings:
        kind = TEX_TYPE[type(tex)]
        if kind == 0:
            par = [tex.scale, *tex.color1, *tex.color2]
        elif kind == 1:
            par = [tex.scale, tex.sharpness, *tex.base_color,
                   *tex.vein_color]
        elif kind == 2:
            par = [tex.scale, tex.ring_width, *tex.base_color,
                   *tex.ring_color]
        elif kind == 3:
            par = [*_unit_direction(tex.direction).tolist(), *tex.color1,
                   *tex.color2]
        elif kind in (4, 5):
            weights, norm = _octaves(tex.octaves, tex.lacunarity,
                                     tex.persistence)
            amplitude = tex.amplitude if kind == 4 else 1.0
            par = [tex.scale, tex.octaves, _seed_f(tex.seed), norm,
                   amplitude, n_aux]
            aux.append(torch.tensor([[a, f, 0.0] for a, f in weights],
                                    dtype=torch.float32).reshape(-1, 3))
            n_aux += len(weights)
        else:
            fp = tex._feature_points()
            par = [tex.scale, tex.distance_type, n_aux, fp.shape[0]]
            aux.append(fp)
            n_aux += fp.shape[0]
        row = [float(mi), float(kind)] + [float(x) for x in par]
        rows.append(row + [0.0] * (TEX_COLS - len(row)))
    tab = torch.tensor(np.array(rows, np.float32).reshape(-1, TEX_COLS))
    return tab, (torch.cat(aux) if aux
                 else torch.zeros((0, 3), dtype=torch.float32))
