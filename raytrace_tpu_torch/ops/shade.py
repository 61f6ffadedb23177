"""Direct lighting and shadows (port of ``raytrace_tpu/ops/shade.py``).

The reference's quirks are kept on purpose: metallic-tiered ambient and
diffuse strengths; diffuse from the surface albedo only; Blinn-Phong
specular only above metallic 0.5 with its view direction toward the WORLD
ORIGIN; one hard shadow ray that, when blocked, zeroes the light, else the
mean of ``shadow_samples`` rays along normalize(lightDir + 0.1*ball);
lights nearer than 1e-3 skipped; 1/d^2 falloff.
"""

from __future__ import annotations

import torch

from . import intersect
from .. import rng
from .._f32 import div as _div
from .._f32 import sqrt as _sqrt


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _norm(v):
    return _sqrt(_dot(v, v))


def _normalize(v):
    n = _norm(v)[..., None]
    pos = n > 0.0
    return torch.where(pos, v / torch.where(pos, n, torch.ones_like(n)),
                       torch.zeros_like(v))


def _tiers(x, table, default):
    """where(x > t0, v0, where(x > t1, v1, ... default)) in float32."""
    out = torch.full_like(x, default)
    for thresh, val in reversed(table):
        out = torch.where(x > thresh, torch.full_like(x, val), out)
    return out


def ambient_strength(metallic):
    return _tiers(metallic, [(0.9, 0.05), (0.7, 0.07), (0.5, 0.08)], 0.1)


def diffuse_strength(metallic):
    return _tiers(metallic, [(0.95, 0.05), (0.9, 0.08), (0.8, 0.12),
                             (0.7, 0.15), (0.5, 0.2)], 0.25)


def specular_power(metallic):
    return _tiers(metallic, [(0.9, 64.0), (0.8, 48.0)], 32.0)


def combine_weights(metallic):
    """Tiered (reflection, direct) weights; (1, 1) at metallic <= 0.2."""
    refl = _tiers(metallic, [(0.95, 0.85), (0.9, 0.8), (0.8, 0.75),
                             (0.7, 0.7), (0.5, 0.6), (0.2, 0.4)], 1.0)
    direct = torch.where(metallic > 0.2, 1.0 - refl, torch.ones_like(refl))
    return refl, direct


# Soft-shadow samples are tested together, as one wavefront of at most
# this many lanes: the tree walk's cost is its step count, not its width.
SOFT_BATCH_LANES = 1 << 18


def shadow_factor(geom, point, light_dist, light_dir, pix_id, samp_id,
                  bounce, light_index, *, soft_shadows=True,
                  shadow_samples=16, seed=0, accel=None, occluders=None):
    """(B,) shadow factor in [0, 1]. Each soft sample is its own
    occlusion ray (with ``accel``, its own tree walk); samples are drawn
    and tested together, in wavefronts of up to SOFT_BATCH_LANES lanes,
    which changes no draw and no verdict. ``occluders`` (B, N) bool: the
    primitives each lane's soft rays test (``intersect.any_hit``'s
    order; K1-guard's flags), all of them when None."""
    hard = intersect.any_hit(geom, point, light_dir, 1e-3, light_dist,
                             accel=accel)
    if not soft_shadows:
        return torch.where(hard, 0.0, 1.0)
    n = point.shape[0]
    per = max(1, min(shadow_samples, SOFT_BATCH_LANES // max(n, 1)))
    unblocked = torch.zeros_like(light_dist)
    for i0 in range(0, shadow_samples, per):
        k = min(per, shadow_samples - i0)
        sample = torch.arange(i0, i0 + k, device=point.device)
        stream = rng.bounce_stream(
            bounce, rng.shadow_stream(light_index, sample, shadow_samples))
        ball = rng.unit_ball(pix_id.repeat(k), samp_id.repeat(k),
                             stream.repeat_interleave(n), seed)
        dirs = _normalize(light_dir.repeat(k, 1) + 0.1 * ball)
        blocked = intersect.any_hit(
            geom, point.repeat(k, 1), dirs, 1e-3, light_dist.repeat(k),
            accel=accel, occluders=None if occluders is None
            else occluders.repeat(k, 1)).reshape(k, n)
        # a count of unblocked rays: exact in float32, so any order
        unblocked += (~blocked).sum(0).to(unblocked.dtype)
    return torch.where(hard, 0.0, _div(unblocked, float(shadow_samples)))


def direct_lighting(geom, lights, mat, point, normal, pix_id, samp_id,
                    bounce, *, soft_shadows=True, shadow_samples=16,
                    seed=0, accel=None):
    """(B,3) direct light at the hit points."""
    metallic = mat["metallic"]
    albedo = mat["eff_albedo"]
    total = ambient_strength(metallic)[..., None].expand_as(point)
    dstr = diffuse_strength(metallic)
    spow = specular_power(metallic)
    view_dir = _normalize(-point)
    for li in range(lights.position.shape[0]):
        to_light = lights.position[li] - point
        light_dist = _norm(to_light)
        light_dir = _normalize(to_light)
        live = light_dist >= 1e-3
        sf = shadow_factor(geom, point, light_dist, light_dir, pix_id,
                           samp_id, bounce, li, soft_shadows=soft_shadows,
                           shadow_samples=shadow_samples, seed=seed,
                           accel=accel)
        cos_theta = torch.clamp(_dot(normal, light_dir), min=0.0)
        intensity = cos_theta * lights.intensity[li] / (light_dist
                                                        * light_dist)
        diffuse = albedo * (dstr * intensity * sf)[..., None]
        half_dir = _normalize(light_dir + view_dir)
        spec_i = torch.pow(torch.clamp(_dot(normal, half_dir), min=0.0),
                           spow)
        spec_scale = torch.where(
            metallic > 0.5, spec_i * intensity * sf * metallic * 3.0, 0.0)
        specular = lights.color[li][None, :] * spec_scale[..., None]
        total = total + torch.where(live[..., None], diffuse + specular,
                                    0.0)
    return total
