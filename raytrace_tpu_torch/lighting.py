"""Light types and local illumination models (port of
``raytrace_tpu/lighting.py``), batched over a leading lane shape:

* ``PointLight`` with the reference's 1 / (1 + 0.09 d + 0.032 d^2)
  attenuation, ``DirectionalLight``, ``AreaLight`` (one jittered sample,
  or ``integrate``: the mean of its N samples, each tested for
  visibility when a geometry is given) and ``SpotLight`` with a smooth
  inner/outer cutoff. Each holds its tensors on ``device`` (None: the
  card, through ``_device.resolve``); the points it is sampled at must be
  there too.
* The ``phong`` and ``blinn_phong`` models.
* ``ambient_occlusion`` (plain PyTorch ``intersect.any_hit`` tests, as
  the JAX function runs outside any Pallas kernel) and
  ``one_bounce_indirect``, which traces its hemisphere rays through
  ``megakernel.trace``: on the card the scene's trace kernel (K1, K3+K4,
  K5 or K7), on the CPU the eager engine, its plain version. The JAX
  function traces with its jnp engine; the two agree to the kernels'
  tolerance of their plain version (README).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import _device
from . import rng
from . import trace as trace_mod
from .fastmath import vec3_dot as _dot
from .fastmath import vec3_normalize as _norm
from .ops import intersect
from .ops import megakernel


def _vec(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class LightSample:
    """A lane's light sample: the unit direction to the light, the
    distance and the incident radiance (colour times attenuated
    intensity)."""

    direction: torch.Tensor  # (B,3)
    distance: torch.Tensor   # (B,)
    radiance: torch.Tensor   # (B,3)


class PointLight:
    def __init__(self, position, color=(1, 1, 1), intensity=1.0,
                 constant=1.0, linear=0.09, quadratic=0.032, device=None):
        self.device = _device.resolve(device)
        self.position = _vec(position, self.device)
        self.color = _vec(color, self.device)
        self.intensity = float(intensity)
        self.constant, self.linear, self.quadratic = (
            float(constant), float(linear), float(quadratic))

    def sample(self, point, pix_id=None, samp_id=None, seed=0):
        to_l = self.position - point
        dist = torch.linalg.vector_norm(to_l, dim=-1)
        att = 1.0 / (self.constant + self.linear * dist
                     + self.quadratic * dist * dist)
        return LightSample(_norm(to_l), dist,
                           self.color * (self.intensity * att)[..., None])


class DirectionalLight:
    """A constant direction with no falloff."""

    def __init__(self, direction, color=(1, 1, 1), intensity=1.0,
                 device=None):
        self.device = _device.resolve(device)
        self.direction = _vec(direction, self.device)
        self.color = _vec(color, self.device)
        self.intensity = float(intensity)

    def sample(self, point, pix_id=None, samp_id=None, seed=0):
        d = -_norm(self.direction)  # toward the light
        return LightSample(
            d.expand(point.shape),
            torch.full(point.shape[:-1], 1e8, dtype=torch.float32,
                       device=point.device),
            (self.color * self.intensity).expand(point.shape))


class AreaLight:
    """A rectangular emitter: ``sample`` draws one point of it per lane
    from the counter RNG (stream ``stream``), ``integrate`` averages its
    ``samples`` draws."""

    def __init__(self, position, u_edge, v_edge, color=(1, 1, 1),
                 intensity=1.0, samples=16, device=None):
        self.device = _device.resolve(device)
        self.position = _vec(position, self.device)
        self.u_edge = _vec(u_edge, self.device)
        self.v_edge = _vec(v_edge, self.device)
        self.color = _vec(color, self.device)
        self.intensity = float(intensity)
        self.samples = int(samples)

    def sample(self, point, pix_id=None, samp_id=None, seed=0, stream=0):
        if pix_id is None:  # the center
            pos = (self.position + 0.5 * self.u_edge
                   + 0.5 * self.v_edge).expand(point.shape)
        else:
            u, v, _, _ = rng.uniform4(pix_id, samp_id, stream, seed)
            pos = (self.position + u[..., None] * self.u_edge
                   + v[..., None] * self.v_edge)
        to_l = pos - point
        dist = torch.linalg.vector_norm(to_l, dim=-1)
        att = 1.0 / torch.clamp(dist * dist, min=1e-6)
        return LightSample(_norm(to_l), dist,
                           self.color * (self.intensity * att)[..., None])

    def integrate(self, point, pix_id=None, samp_id=None, seed=0,
                  stream_base=0, geom=None, accel=None):
        """The mean of ``samples`` emitter samples (streams stream_base
        on); with ``geom`` each one is blocked by any primitive between
        the point and the emitter (a soft shadow). The direction and
        distance are those to the emitter's center."""
        total = torch.zeros_like(point)
        for s in range(self.samples):
            ls = self.sample(point, pix_id, samp_id, seed,
                             stream=stream_base + s)
            contrib = ls.radiance
            if geom is not None:
                blocked = intersect.any_hit(geom, point, ls.direction, 1e-3,
                                            ls.distance, accel=accel)
                contrib = torch.where(blocked[..., None],
                                      torch.zeros_like(contrib), contrib)
            total = total + contrib
        center = self.sample(point)
        return LightSample(center.direction, center.distance,
                           total / float(self.samples))


class SpotLight:
    """A cone with a smooth step between the inner and outer cutoffs and
    1 / d^2 falloff."""

    def __init__(self, position, direction, color=(1, 1, 1),
                 intensity=1.0, inner_cutoff_deg=12.5,
                 outer_cutoff_deg=17.5, device=None):
        self.device = _device.resolve(device)
        self.position = _vec(position, self.device)
        self.direction = _norm(_vec(direction, self.device))
        self.color = _vec(color, self.device)
        self.intensity = float(intensity)
        self.cos_inner = math.cos(math.radians(inner_cutoff_deg))
        self.cos_outer = math.cos(math.radians(outer_cutoff_deg))

    def sample(self, point, pix_id=None, samp_id=None, seed=0):
        to_l = self.position - point
        dist = torch.linalg.vector_norm(to_l, dim=-1)
        ldir = _norm(to_l)
        cos_theta = _dot(-ldir, self.direction)
        t = torch.clamp((cos_theta - self.cos_outer)
                        / max(self.cos_inner - self.cos_outer, 1e-6),
                        0.0, 1.0)
        att = t * t * (3.0 - 2.0 * t) / torch.clamp(dist * dist, min=1e-6)
        return LightSample(ldir, dist,
                           self.color * (self.intensity * att)[..., None])


# ----------------------------------------------------- shading ----

def phong(normal, view_dir, light: LightSample, albedo, ambient=0.1,
          diffuse_k=1.0, specular_k=0.5, shininess=32.0):
    """Ambient + diffuse + specular around the reflected light ray."""
    n, v, l = _norm(normal), _norm(view_dir), light.direction
    ndotl = torch.clamp(_dot(n, l), min=0.0)
    refl = _norm(2.0 * ndotl[..., None] * n - l)
    spec = torch.pow(torch.clamp(_dot(refl, v), min=0.0), shininess)
    return (albedo * ambient
            + albedo * light.radiance * (diffuse_k * ndotl)[..., None]
            + light.radiance * (specular_k * spec)[..., None])


def blinn_phong(normal, view_dir, light: LightSample, albedo, ambient=0.1,
                diffuse_k=1.0, specular_k=0.5, shininess=32.0):
    """Specular around the half vector (the renderer's own model)."""
    n, v, l = _norm(normal), _norm(view_dir), light.direction
    h = _norm(l + v)
    ndotl = torch.clamp(_dot(n, l), min=0.0)
    spec = torch.pow(torch.clamp(_dot(n, h), min=0.0), shininess)
    return (albedo * ambient
            + albedo * light.radiance * (diffuse_k * ndotl)[..., None]
            + light.radiance * (specular_k * spec)[..., None])


# ------------------------------------------- global illumination ----

def ambient_occlusion(geom, point, normal, pix_id, samp_id, *,
                      samples: int = 16, radius: float = 1.0,
                      seed: int = 0, stream_base: int = 100):
    """The share of ``samples`` rays around the normal that nothing blocks
    within ``radius``."""
    unblocked = torch.zeros(point.shape[:-1], dtype=torch.float32,
                            device=point.device)
    for s in range(samples):
        ball = rng.unit_ball(pix_id, samp_id, stream_base + s, seed)
        d = _norm(normal + ball)
        blocked = intersect.any_hit(geom, point, d, 1e-3, radius)
        unblocked = unblocked + (~blocked).to(torch.float32)
    return unblocked / samples


def one_bounce_indirect(scene, point, normal, pix_id, samp_id, *,
                        samples: int = 8, seed: int = 0,
                        stream_base: int = 200, cfg=None):
    """Indirect light by tracing ``samples`` rays from each point around
    its normal (origins at the points, directions normal + a ball draw)
    through ``megakernel.trace``, averaged."""
    cfg = cfg or trace_mod.TraceConfig(max_depth=2, shadow_samples=4)
    total = torch.zeros_like(point)
    for s in range(samples):
        ball = rng.unit_ball(pix_id, samp_id, stream_base + s, seed)
        d = _norm(normal + ball)
        total = total + megakernel.trace(scene, point, d, pix_id, samp_id,
                                         cfg)
    return total / samples
