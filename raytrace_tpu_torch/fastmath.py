"""Fast-math surface (port of ``raytrace_tpu/fastmath.py``).

* ``FastRandom``: the reference's xorshift64* generator (shifts 12/25/27,
  multiplier 2685821657736338717), on host Python ints, bit for bit;
  ``xorshift64star`` is one step of it on a tensor of states, a lane's
  own state each.
* The ``fast_*`` wrappers: aliases of the PyTorch operators, vectorised.
* The ``vec3_*`` algebra on (..., 3) tensors, with the reference's
  zero-vector normalisation and refraction fallback.
* The lattice value noise and its fbm: the copy in ``models/textures.py``
  (the one the textures evaluate), re-exported; the 1-D and 2-D forms are
  the 3-D noise on the planes z = 0 and y = z = 0, which gives the JAX
  package's 1-D and 2-D noise bit for bit (the extra lerps weigh 0).
* The number-theory predicates, as vectorised loops.

64-bit states live in int64 tensors that hold the uint64 bit pattern:
PyTorch's unsigned 64-bit integers have no shifts on the CPU. A logical
right shift masks the arithmetic one; left shifts and the multiply wrap
mod 2^64 in int64 as they do in uint64.
"""

from __future__ import annotations

import math

import torch

from .models.textures import fast_noise_3d, fbm_3d

__all__ = ["FastRandom", "xorshift64star", "fast_noise_1d", "fast_noise_2d",
           "fast_noise_3d", "fbm_3d", "is_prime", "fibonacci",
           "is_palindrome_number"]

_MASK64 = 0xFFFFFFFFFFFFFFFF
_XS_MULT = 2685821657736338717
_F64_SCALE = 1.0 / (1 << 53)


class FastRandom:
    """xorshift64*, bit-compatible with the reference's FastRandom: a
    stateful host generator (``xorshift64star`` is the tensor form)."""

    def __init__(self, seed: int):
        self.state = (seed if seed != 0 else 1) & _MASK64

    def next_uint64(self) -> int:
        x = self.state
        x ^= x >> 12
        x ^= (x << 25) & _MASK64
        x ^= x >> 27
        self.state = x
        return (x * _XS_MULT) & _MASK64

    def float64(self) -> float:
        """The top 53 bits over 2^53, in [0, 1)."""
        return (self.next_uint64() >> 11) * _F64_SCALE

    def float64_range(self, lo: float, hi: float) -> float:
        return lo + (hi - lo) * self.float64()

    def int_range(self, lo: int, hi: int) -> int:
        return lo + self.next_uint64() % (hi - lo)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the uint64 bit pattern held in int64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def xorshift64star(state: torch.Tensor):
    """One xorshift64* step per lane: (new state, output), in the dtype of
    ``state``, which must be int64 (the uint64 bit pattern) or uint64."""
    if state.dtype not in (torch.int64, torch.uint64):
        raise TypeError(f"xorshift64star needs int64 or uint64 state (got "
                        f"{state.dtype}): a narrower type drops the high "
                        "bits and the sequence leaves the reference's")
    x = state.view(torch.int64)
    x = x ^ _shr(x, 12)
    x = x ^ (x << 25)
    x = x ^ _shr(x, 27)
    out = x * _XS_MULT
    return x.view(state.dtype), out.view(state.dtype)


def _t(x) -> torch.Tensor:
    """A float32 tensor of x (a tensor keeps its device)."""
    return torch.as_tensor(x, dtype=torch.float32)


# ------------------------------------------------------- wrappers ----

fast_sqrt = torch.sqrt
fast_pow = torch.pow
fast_exp = torch.exp
fast_log = torch.log
fast_log2 = torch.log2
fast_log10 = torch.log10
fast_sin = torch.sin
fast_cos = torch.cos
fast_tan = torch.tan
fast_asin = torch.asin
fast_acos = torch.acos
fast_atan = torch.atan
fast_atan2 = torch.atan2
fast_sinh = torch.sinh
fast_cosh = torch.cosh
fast_tanh = torch.tanh
fast_floor = torch.floor
fast_ceil = torch.ceil
fast_round = torch.round          # half to even, as jnp.round
fast_abs = torch.abs
fast_mod = torch.remainder        # the sign of the divisor, as jnp.mod
fast_min = torch.minimum
fast_max = torch.maximum
fast_hypot = torch.hypot
fast_inv_sqrt = torch.rsqrt


def fast_cbrt(x):
    """The real cube root (torch has no cbrt)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def fast_clamp(x, lo, hi):
    return torch.clamp(_t(x), lo, hi)


def fast_lerp(a, b, t):
    return a + (b - a) * t


def fast_smooth_step(edge0, edge1, x):
    """3t^2 - 2t^3 of t = (x - edge0) / (edge1 - edge0) clamped."""
    t = torch.clamp((_t(x) - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def fast_smoother_step(edge0, edge1, x):
    """6t^5 - 15t^4 + 10t^3."""
    t = torch.clamp((_t(x) - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def fast_sign(x):
    return torch.sign(x)


def fast_step(edge, x):
    x = _t(x)
    return torch.where(x < edge, torch.zeros_like(x), torch.ones_like(x))


def fast_fract(x):
    return x - torch.floor(x)


def fast_radians(deg):
    return deg * (math.pi / 180.0)


def fast_degrees(rad):
    return rad * (180.0 / math.pi)


# ---------------------------------------------------------- vec3 ----

def _per_lane(s, a):
    """A per-lane scalar (one dim fewer than a) gets a trailing axis."""
    s = torch.as_tensor(s, device=a.device)
    return s[..., None] if s.dim() == a.dim() - 1 else s


def vec3_add(a, b):
    return a + b


def vec3_sub(a, b):
    return a - b


def vec3_mul(a, s):
    return a * _per_lane(s, a)


def vec3_div(a, s):
    return a / _per_lane(s, a)


def vec3_dot(a, b):
    return torch.sum(a * b, dim=-1)


def vec3_cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def vec3_length(a):
    return torch.linalg.vector_norm(a, dim=-1)


def vec3_length_squared(a):
    return torch.sum(a * a, dim=-1)


def vec3_normalize(a):
    """The reference's Normalize: a zero vector stays zero."""
    n = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    pos = n > 0.0
    return torch.where(pos, a / torch.where(pos, n, torch.ones_like(n)),
                       torch.zeros_like(a))


def vec3_reflect(v, n):
    return v - 2.0 * vec3_dot(v, n)[..., None] * n


def vec3_refract(v, n, eta):
    """Refraction with the reference's inside flip and its total internal
    reflection fallback."""
    cos = vec3_dot(v, n)[..., None]
    flip = cos > 0.0
    n2 = torch.where(flip, -n, n)
    eta = torch.as_tensor(eta, dtype=v.dtype, device=v.device)
    eta2 = torch.where(flip, 1.0 / eta, eta)
    cos2 = torch.where(flip, -cos, cos)
    sin_t2 = eta2 * eta2 * (1.0 - cos2 * cos2)
    tir = sin_t2 > 1.0
    cos_t2 = torch.sqrt(torch.where(tir, torch.ones_like(sin_t2),
                                    torch.clamp(1.0 - sin_t2, min=0.0)))
    refracted = v * eta2 - n2 * (eta2 * cos2 + cos_t2)
    return torch.where(tir, vec3_reflect(v, n2), refracted)


def vec3_distance(a, b):
    return vec3_length(a - b)


def vec3_lerp(a, b, t):
    return a + (b - a) * _per_lane(t, a)


# --------------------------------------------------------- noise ----

def fast_noise_1d(x, seed: int = 0):
    """Smoothed value noise on the integer lattice, in [0, 1)."""
    x = _t(x)
    z = torch.zeros_like(x)
    return fast_noise_3d(x, z, z, seed=seed)


def fast_noise_2d(x, y, seed: int = 0):
    x, y = torch.broadcast_tensors(_t(x), _t(y))
    return fast_noise_3d(x, y, torch.zeros_like(x), seed=seed)


# ------------------------------------------------- number theory ----

def is_prime(n):
    """Trial division of every lane at once, (shape of n) bool."""
    n = torch.as_tensor(n).to(torch.int32)
    comp = torch.zeros_like(n, dtype=torch.bool)
    i = 2
    while bool((i * i <= n).any()):
        comp |= (i * i <= n) & (n % i == 0) & (i < n)
        i += 1
    return (n >= 2) & ~comp


def fibonacci(k: int, device=None) -> torch.Tensor:
    """The first k Fibonacci numbers, int64."""
    out, a, b = [], 0, 1
    for _ in range(k):
        out.append(a)
        a, b = b, a + b
    return torch.tensor(out, dtype=torch.int64, device=device)


def is_palindrome_number(n):
    """Is the decimal number a palindrome? Lane for lane, on int64."""
    n = torch.as_tensor(n).to(torch.int64)
    rev = torch.zeros_like(n)
    rem = n.clone()
    while bool((rem > 0).any()):
        rev = torch.where(rem > 0, rev * 10 + rem % 10, rev)
        rem = torch.div(rem, 10, rounding_mode="floor")
    return rev == n
