"""Camera ray generation (port of ``raytrace_tpu/camera.py``).

``go_rays`` is the reference camera: a fixed viewport of height 2 and width
2*aspectRatio at focal length 1 along -Z, ignoring lookAt/up/fov.
``lookat_rays`` honours them. Directions are not normalised (the Metal
Fresnel term depends on their length). Thin-lens depth of field is not in
this slice of the port (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import torch

from ._f32 import sqrt as _sqrt


def go_rays(camera, u: torch.Tensor, v: torch.Tensor):
    """Rays for u, v in [0, 1]: (origin (B,3), direction (B,3))."""
    vp_w = 2.0 * camera.aspect_ratio
    zero = torch.zeros_like(vp_w)
    origin = camera.position
    horizontal = torch.stack([vp_w, zero, zero])
    vertical = torch.tensor([0.0, 2.0, 0.0], dtype=origin.dtype,
                            device=origin.device)
    lower_left = (origin - horizontal / 2.0 - vertical / 2.0
                  - torch.tensor([0.0, 0.0, 1.0], dtype=origin.dtype,
                                 device=origin.device))
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
