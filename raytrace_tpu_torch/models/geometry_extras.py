"""Geometry queries of spheres and triangles (port of
``raytrace_tpu/models/geometry_extras.py``): batched over a leading
shape, on the device of their inputs, with the reference's quirks as
the JAX package keeps them.

* ``triangle_contains_point`` solves the barycentric system for
  w = v0 - point (not point - v0), as the reference writes it: not a
  correct containment test, and ``triangle_closest_point`` inherits it.
* ``triangle_closest_point`` falls back to the nearest vertex, never to
  an edge point.
* ``sphere_intersection_volume`` takes one cap height
  h = (r1 + r2 - d) / 2, exact only for equal radii.
* Normalisation keeps the zero vector, so ``sphere_closest_point`` of
  the center is the center.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..fastmath import vec3_cross as _cross
from ..fastmath import vec3_dot as _dot
from ..fastmath import vec3_normalize

__all__ = [
    "sphere_surface_area", "sphere_volume", "sphere_contains_point",
    "sphere_closest_point", "sphere_distance_to_point",
    "sphere_normal_at_point", "spheres_intersect",
    "sphere_intersection_volume",
    "triangle_bounding_box", "triangle_area", "triangle_centroid",
    "triangle_contains_point", "triangle_closest_point",
    "triangle_distance_to_point",
]

_PI = float(np.float32(math.pi))  # pi rounded to float32, as the JAX package


def _f32(*xs):
    """float32 tensors of xs, on the device of the first tensor among
    them."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in xs]


# -------------------------------------------------------- spheres ----

def sphere_surface_area(radius):
    (r,) = _f32(radius)
    return 4.0 * _PI * r * r


def sphere_volume(radius):
    (r,) = _f32(radius)
    return (4.0 / 3.0) * _PI * r * r * r


def sphere_contains_point(center, radius, point):
    """|p - c|^2 <= r^2, the boundary inside."""
    center, radius, point = _f32(center, radius, point)
    d = point - center
    return _dot(d, d) <= radius ** 2


def sphere_closest_point(center, radius, point):
    center, radius, point = _f32(center, radius, point)
    return center + vec3_normalize(point - center) * radius[..., None]


def sphere_distance_to_point(center, radius, point):
    """max(0, |p - c| - r): 0 inside."""
    center, radius, point = _f32(center, radius, point)
    d = point - center
    return torch.clamp(torch.sqrt(_dot(d, d)) - radius, min=0.0)


def sphere_normal_at_point(center, point):
    center, point = _f32(center, point)
    return vec3_normalize(point - center)


def spheres_intersect(c1, r1, c2, r2):
    """|c1 - c2| <= r1 + r2."""
    c1, r1, c2, r2 = _f32(c1, r1, c2, r2)
    d = c1 - c2
    return torch.sqrt(_dot(d, d)) <= r1 + r2


def sphere_intersection_volume(c1, r1, c2, r2):
    """The reference's overlap volume: the smaller sphere's volume when
    one holds the other (d <= |r1 - r2|), else one symmetric cap term."""
    c1, r1, c2, r2 = _f32(c1, r1, c2, r2)
    d = torch.sqrt(torch.sum((c1 - c2) ** 2, dim=-1))
    rmin = torch.minimum(r1, r2)
    contained = (4.0 / 3.0) * _PI * rmin * rmin * rmin
    h = (r1 + r2 - d) / 2.0
    partial = _PI * h * h * (3.0 * (r1 + r2) - h) / 3.0
    vol = torch.where(d <= torch.abs(r1 - r2), contained, partial)
    return torch.where(d > r1 + r2, torch.zeros_like(vol), vol)


# ------------------------------------------------------ triangles ----

def triangle_bounding_box(v0, v1, v2):
    v = torch.stack(_f32(v0, v1, v2), dim=-2)
    return torch.amin(v, dim=-2), torch.amax(v, dim=-2)


def triangle_area(v0, v1, v2):
    """|e1 x e2| / 2."""
    v0, v1, v2 = _f32(v0, v1, v2)
    c = _cross(v1 - v0, v2 - v0)
    return torch.sqrt(_dot(c, c)) / 2.0


def triangle_centroid(v0, v1, v2):
    v0, v1, v2 = _f32(v0, v1, v2)
    return (v0 + v1 + v2) / 3.0


def triangle_contains_point(v0, v1, v2, point):
    """The reference's test as written: the 2x2 barycentric solve for
    w = v0 - point (see the module docstring)."""
    v0, v1, v2, point = _f32(v0, v1, v2, point)
    e1, e2 = v1 - v0, v2 - v0
    w = v0 - point
    dot00, dot01, dot02 = _dot(w, w), _dot(w, e1), _dot(w, e2)
    dot11, dot12 = _dot(e1, e1), _dot(e1, e2)
    denom = dot00 * dot11 - dot01 * dot01
    inv = 1.0 / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    u = (dot11 * dot02 - dot01 * dot12) * inv
    v = (dot00 * dot12 - dot01 * dot02) * inv
    return (denom != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)


def triangle_closest_point(v0, v1, v2, point):
    """The projection on the triangle's plane where the (quirky) contains
    test takes it, else the nearest vertex (the first on ties)."""
    v0, v1, v2, point = _f32(v0, v1, v2, point)
    n = vec3_normalize(_cross(v1 - v0, v2 - v0))
    dist = _dot(point - v0, n)
    on_plane = point - n * dist[..., None]
    inside = triangle_contains_point(v0, v1, v2, on_plane)
    d0 = torch.sum((point - v0) ** 2, dim=-1)
    d1 = torch.sum((point - v1) ** 2, dim=-1)
    d2 = torch.sum((point - v2) ** 2, dim=-1)
    best = torch.where((d1 < d0)[..., None], v1, v0)
    best = torch.where((d2 < torch.minimum(d0, d1))[..., None], v2, best)
    return torch.where(inside[..., None], on_plane, best)


def triangle_distance_to_point(v0, v1, v2, point):
    _, p = _f32(v0, point)
    d = p - triangle_closest_point(v0, v1, v2, point)
    return torch.sqrt(_dot(d, d))
