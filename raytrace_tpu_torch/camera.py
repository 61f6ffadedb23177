"""Camera ray generation (port of ``raytrace_tpu/camera.py``).

``go_rays`` is the reference camera: a fixed viewport of height 2 and width
2*aspectRatio at focal length 1 along -Z, ignoring lookAt/up/fov.
``lookat_rays`` honours them. Directions are not normalised (the Metal
Fresnel term depends on their length). ``thin_lens_perturb`` moves either
camera's rays onto a thin lens (depth of field).
"""

from __future__ import annotations

import torch

from . import rng
from ._f32 import sqrt as _sqrt


def go_rays(camera, u: torch.Tensor, v: torch.Tensor):
    """Rays for u, v in [0, 1]: (origin (B,3), direction (B,3))."""
    vp_w = 2.0 * camera.aspect_ratio
    zero = torch.zeros_like(vp_w)
    origin = camera.position
    horizontal = torch.stack([vp_w, zero, zero])
    # built on the device: a host tensor would be a copy, which syncs
    vertical = torch.stack([zero, zero + 2.0, zero]).to(origin.dtype)
    lower_left = (origin - horizontal / 2.0 - vertical / 2.0
                  - torch.stack([zero, zero, zero + 1.0]).to(origin.dtype))
    direction = (lower_left[None, :] + u[..., None] * horizontal[None, :]
                 + v[..., None] * vertical[None, :] - origin[None, :])
    return origin.expand_as(direction), direction


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _norm(a):
    return _sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2])


def lookat_basis(camera):
    """(forward, right, up, half_w, half_h) of the look-at camera."""
    fwd = camera.look_at - camera.position
    fwd = fwd / _norm(fwd)
    right = _cross(fwd, camera.up)
    right = right / _norm(right)
    up = _cross(right, fwd)
    theta = camera.fov * (torch.pi / 180.0)
    half_h = torch.tan(theta / 2.0)
    half_w = camera.aspect_ratio * half_h
    return fwd, right, up, half_w, half_h


def lookat_rays(camera, u: torch.Tensor, v: torch.Tensor):
    """Right-handed look-at pinhole camera using fov/lookAt/up."""
    fwd, right, up, half_w, half_h = lookat_basis(camera)
    direction = (fwd[None, :]
                 + (2.0 * u[..., None] - 1.0) * half_w * right[None, :]
                 + (2.0 * v[..., None] - 1.0) * half_h * up[None, :])
    return camera.position.expand_as(direction), direction


def thin_lens_perturb(camera, origin, direction, pix_id, samp_id, seed,
                      lens_radius: float = 0.1,
                      focus_distance: float = 10.0):
    """Thin-lens depth of field (advanced.go:29-44): (origin, direction)
    of rays through a lens point, aimed at the focal point.

    The reference's quirks are kept: the offset basis is
    ``Up * rd.x + normalize(LookAt x Up) * rd.y``, with LookAt the look-at
    POINT, not a view direction (so the basis need not be orthonormal);
    the output direction IS normalised, unlike primary rays. The disk
    sample is the counter-based ``rng.unit_disk`` at the DOF_DISK site."""
    rd = rng.unit_disk(pix_id, samp_id, rng.Streams.DOF_DISK, seed)
    rd = rd * lens_radius
    up = camera.up
    cr = _cross(camera.look_at, up)  # LookAt x Up, the reference's basis
    n = _norm(cr)
    cr = torch.where(n > 0, cr / torch.where(n > 0, n, torch.ones_like(n)),
                     cr)
    offset = rd[..., 0:1] * up[None, :] + rd[..., 1:2] * cr[None, :]
    new_origin = origin + offset
    new_dir = direction * focus_distance - offset
    nd = _sqrt(new_dir[..., 0] * new_dir[..., 0]
               + new_dir[..., 1] * new_dir[..., 1]
               + new_dir[..., 2] * new_dir[..., 2])[..., None]
    new_dir = torch.where(nd > 0, new_dir / torch.where(
        nd > 0, nd, torch.ones_like(nd)), new_dir)
    return new_origin, new_dir
