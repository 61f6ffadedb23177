"""Ray utilities (port of ``raytrace_tpu/rays.py``): batched forms of the
reference's Ray methods on (..., 3) tensors, on the device of their
inputs.

A ray is the pair (origin, direction). The reference's quirks stay, as in
the JAX package: ``distance_to_point`` is the signed projection of
(point - origin) onto the unit direction, not a distance; ``scale``
scales the origin and normalises the direction; ``is_point_on_ray``
compares the squared distance with tolerance^2; a ray at the world origin
is not ``is_valid``; ``distance_to_ray`` falls back to the projection for
parallel rays.
"""

from __future__ import annotations

import torch

from .fastmath import vec3_cross as _cross
from .fastmath import vec3_dot as _dot
from .fastmath import vec3_normalize as _norm

NEAR_ZERO = 1e-8  # the reference's Vec3.NearZero threshold


def _t(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def at(origin, direction, t):
    """Ray.At: origin + t * direction."""
    return origin + direction * _t(t, origin)[..., None]


def point_at_distance(origin, direction, distance):
    """GetPointAtDistance: along the normalised direction."""
    return origin + _norm(direction) * _t(distance, origin)[..., None]


def distance_to_point(origin, direction, point):
    """GetDistanceToPoint: the signed projection, as the reference has it."""
    return _dot(point - origin, _norm(direction))


def closest_point_on_ray(origin, direction, point):
    """GetClosestPointOnRay: the unclamped line projection."""
    u = _norm(direction)
    return origin + u * _dot(point - origin, u)[..., None]


def distance_to_point_squared(origin, direction, point):
    d = point - closest_point_on_ray(origin, direction, point)
    return _dot(d, d)


def is_point_on_ray(origin, direction, point, tolerance=1e-6):
    return distance_to_point_squared(origin, direction,
                                     point) <= tolerance * tolerance


def rotate(origin, direction, axis, angle):
    """Ray.Rotate: the Rodrigues matrix applied to origin and direction."""
    axis = _t(axis, origin)
    angle = _t(angle, origin)
    c, s = torch.cos(angle), torch.sin(angle)
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    one_c = 1.0 - c
    m = torch.stack([
        torch.stack([c + ax * ax * one_c, ax * ay * one_c - az * s,
                     ax * az * one_c + ay * s], -1),
        torch.stack([ay * ax * one_c + az * s, c + ay * ay * one_c,
                     ay * az * one_c - ax * s], -1),
        torch.stack([az * ax * one_c - ay * s, az * ay * one_c + ax * s,
                     c + az * az * one_c], -1),
    ], -2)
    rot = lambda v: torch.einsum("...ij,...j->...i", m, v)
    return rot(origin), rot(direction)


def translate(origin, direction, offset):
    return origin + _t(offset, origin), direction


def scale(origin, direction, factor):
    """Ray.Scale: the origin scaled, the direction normalised."""
    return origin * factor, _norm(direction)


def bounding_box(origin, direction):
    """The box of origin and origin + direction."""
    end = origin + direction
    return torch.minimum(origin, end), torch.maximum(origin, end)


def length(direction):
    return torch.linalg.vector_norm(direction, dim=-1)


def is_valid(origin, direction):
    """Neither origin nor direction near zero (so a ray at the origin is
    invalid, as in the reference)."""
    o_near = torch.all(torch.abs(origin) < NEAR_ZERO, dim=-1)
    d_near = torch.all(torch.abs(direction) < NEAR_ZERO, dim=-1)
    return ~o_near & ~d_near


def is_parallel(d1, d2):
    return torch.all(torch.abs(_cross(d1, d2)) < NEAR_ZERO, dim=-1)


def is_perpendicular(d1, d2):
    """|d1 . d2| < 1e-6 on the raw, unnormalised directions."""
    return torch.abs(_dot(d1, d2)) < 1e-6


def angle(d1, d2):
    return torch.arccos(torch.clamp(_dot(_norm(d1), _norm(d2)), -1.0, 1.0))


def distance_to_ray(o1, d1, o2, d2):
    """The closest distance of two lines; for parallel ones the
    reference's projection of o2."""
    cross = _cross(d1, d2)
    parallel = torch.all(torch.abs(cross) < NEAR_ZERO, dim=-1)
    cc = _dot(cross, cross)
    denom = torch.where(parallel, torch.ones_like(cc), cc)
    to_other = o2 - o1
    t1 = _dot(_cross(to_other, d2), cross) / denom
    t2 = _dot(_cross(to_other, d1), cross) / denom
    p1 = o1 + d1 * t1[..., None]
    p2 = o2 + d2 * t2[..., None]
    skew = torch.linalg.vector_norm(p1 - p2, dim=-1)
    return torch.where(parallel, distance_to_point(o1, d1, o2), skew)
