"""Counter-based RNG: the pcg4d hash keyed by (pixel, sample, stream, seed).

Port of ``raytrace_tpu/rng.py``. Every draw is a pure function of its key, so
the port reproduces the JAX package's bits exactly and results do not depend
on how lanes are batched, compacted or ordered.

PyTorch's CPU kernels have no uint32 ``+`` or ``>>``, so the hash runs on
int64 tensors holding uint32 values, masked with ``& 0xFFFFFFFF`` after each
step. Products are split into 16-bit halves so no int64 product overflows.
The CUDA kernels carry the same hash in native uint32
(``csrc/common.cuh``).
"""

from __future__ import annotations

import math

import torch

from ._f32 import sqrt as _sqrt

STREAMS_PER_BOUNCE = 512
_MASK = 0xFFFFFFFF
_M = 1664525
_A = 1013904223
_INV24 = 1.0 / (1 << 24)  # exact in float32


class Streams:
    """Per-bounce draw-site ids (``raytrace_tpu.rng.Streams``)."""

    CAMERA_JITTER = 0
    SCATTER_BALL = 1
    DIELECTRIC = 2
    RUSSIAN_ROULETTE = 3
    DOF_DISK = 4
    SHADOW_BASE = 8


def _u32(x) -> torch.Tensor:
    return x & _MASK


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 tensors holding uint32 values."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def pcg4d(a, b, c, d):
    """pcg4d hash: 4 uint32 (as int64 tensors) -> 4 uint32 (as int64)."""
    x = (_mul(_u32(a), _M) + _A) & _MASK
    y = (_mul(_u32(b), _M) + _A) & _MASK
    z = (_mul(_u32(c), _M) + _A) & _MASK
    w = (_mul(_u32(d), _M) + _A) & _MASK
    x = (x + _mul(y, w)) & _MASK
    y = (y + _mul(z, x)) & _MASK
    z = (z + _mul(x, y)) & _MASK
    w = (w + _mul(y, z)) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul(y, w)) & _MASK
    y = (y + _mul(z, x)) & _MASK
    z = (z + _mul(x, y)) & _MASK
    w = (w + _mul(y, z)) & _MASK
    return x, y, z, w


def _to_unit_float(u: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 uniform in [0, 1) from the top 24 bits."""
    return (u >> 8).to(torch.float32) * _INV24


def uniform4(pix_id, samp_id, stream, seed):
    """Four independent U[0,1) float32 tensors per lane.

    pix_id/samp_id: integer tensors of lane identities; stream and seed:
    Python ints or integer tensors broadcastable to pix_id.
    """
    pix = pix_id.to(torch.int64)
    samp = samp_id.to(torch.int64)
    # a Python int fills on the device (a host tensor would be a copy,
    # which syncs)
    wide = lambda v: (v.to(torch.int64).expand_as(pix)
                      if isinstance(v, torch.Tensor)
                      else torch.full_like(pix, v))
    x, y, z, w = pcg4d(pix, samp, wide(stream), wide(seed))
    return (_to_unit_float(x), _to_unit_float(y), _to_unit_float(z),
            _to_unit_float(w))


_HALF_PI = float(torch.tensor(math.pi / 2.0, dtype=torch.float32))
_S3 = float(torch.tensor(-1.0 / 6.0, dtype=torch.float32))
_S5 = float(torch.tensor(1.0 / 120.0, dtype=torch.float32))
_S7 = float(torch.tensor(-1.0 / 5040.0, dtype=torch.float32))
_C4 = float(torch.tensor(1.0 / 24.0, dtype=torch.float32))
_C6 = float(torch.tensor(-1.0 / 720.0, dtype=torch.float32))
_THIRD = float(torch.tensor(1.0 / 3.0, dtype=torch.float32))


def sincos_2pi(u: torch.Tensor):
    """(sin 2*pi*u, cos 2*pi*u) for u in [0, 1): quadrant reduction and
    short Taylor polynomials, the same float32 operations in the same
    order as ``raytrace_tpu.rng.sincos_2pi``."""
    t = 4.0 * u
    q = torch.floor(t + 0.5)
    r = (t - q) * _HALF_PI
    r2 = r * r
    s = r * (1.0 + r2 * (_S3 + r2 * (_S5 + r2 * _S7)))
    c = 1.0 + r2 * (-0.5 + r2 * (_C4 + r2 * _C6))
    qm = q.to(torch.int32) & 3
    sin = torch.where(qm == 0, s, torch.where(qm == 1, c,
                      torch.where(qm == 2, -s, -c)))
    cos = torch.where(qm == 0, c, torch.where(qm == 1, -s,
                      torch.where(qm == 2, -c, s)))
    return sin, cos


def cbrt01(u: torch.Tensor) -> torch.Tensor:
    """x**(1/3) on [0, 1): a bit-level seed and two Newton steps.

    The seed divides the float's int32 bits by 3; the bits are positive,
    so truncating and floor division agree.
    """
    zero = u <= 0.0
    x = torch.where(zero, torch.ones_like(u), u)
    i = x.view(torch.int32)
    g = (torch.div(i, 3, rounding_mode="floor") + 0x2A514067).view(
        torch.float32)
    for _ in range(2):
        g = (2.0 * g + x / (g * g)) * _THIRD
    return torch.where(zero, torch.zeros_like(g), g)


def unit_ball(pix_id, samp_id, stream, seed) -> torch.Tensor:
    """Uniform sample inside the unit ball, shape (..., 3)."""
    u1, u2, u3, _ = uniform4(pix_id, samp_id, stream, seed)
    z = 2.0 * u1 - 1.0
    sin_p, cos_p = sincos_2pi(u2)
    rho = _sqrt(torch.clamp(1.0 - z * z, min=0.0))
    r = cbrt01(u3)
    return torch.stack([r * rho * cos_p, r * rho * sin_p, r * z], dim=-1)


def unit_disk(pix_id, samp_id, stream, seed) -> torch.Tensor:
    """Uniform sample inside the unit disk, shape (..., 2)."""
    u1, u2, _, _ = uniform4(pix_id, samp_id, stream, seed)
    r = _sqrt(u1)
    sin_t, cos_t = sincos_2pi(u2)
    return torch.stack([r * cos_t, r * sin_t], dim=-1)


def shadow_stream(light_index, sample_index, shadow_samples):
    """Draw-site id of soft-shadow sample `sample_index` of a light."""
    return (Streams.SHADOW_BASE + light_index * (shadow_samples + 1)
            + sample_index)


def bounce_stream(bounce, site):
    """Combine a bounce index with a per-bounce draw-site id."""
    return bounce * STREAMS_PER_BOUNCE + site
