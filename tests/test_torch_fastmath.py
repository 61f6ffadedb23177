"""The port's fastmath against the JAX package's (raytrace_tpu.fastmath).

Tolerances: xorshift64star and FastRandom bit for bit (the JAX known-answer
run under jax.enable_x64, the port on int64 and on uint64 tensors); the
fast_* wrappers, the vec3 algebra and the noise at rtol = atol = 1e-6
(the same float32 operations; XLA's and PyTorch's library functions may
round an ulp apart); the number theory exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu import fastmath as jfm
from raytrace_tpu_torch import fastmath as tfm

TOL = dict(rtol=1e-6, atol=1e-6)


def _states(n=64, seed=0):
    return np.random.default_rng(seed).integers(
        1, 2 ** 63, n, dtype=np.int64).view(np.uint64) * np.uint64(3)


@pytest.mark.parametrize("dtype", [torch.int64, torch.uint64])
def test_xorshift64star_bit_exact(dtype):
    states = _states()
    with jax.enable_x64():
        js, jo = jfm.xorshift64star(jnp.asarray(states, jnp.uint64))
        js, jo = np.asarray(js), np.asarray(jo)
    t = torch.from_numpy(states.view(np.int64).copy())
    if dtype == torch.uint64:
        t = t.view(torch.uint64)
    ts, to = tfm.xorshift64star(t)
    assert ts.dtype == dtype and to.dtype == dtype
    np.testing.assert_array_equal(ts.view(torch.int64).numpy().view(np.uint64),
                                  js)
    np.testing.assert_array_equal(to.view(torch.int64).numpy().view(np.uint64),
                                  jo)
    # a second step from the new state, as a lane carries it
    ts2, to2 = tfm.xorshift64star(ts)
    with jax.enable_x64():
        js2, jo2 = jfm.xorshift64star(jnp.asarray(js, jnp.uint64))
        jo2 = np.asarray(jo2)
    np.testing.assert_array_equal(
        to2.view(torch.int64).numpy().view(np.uint64), jo2)


def test_xorshift64star_rejects_narrow_state():
    with pytest.raises(TypeError):
        tfm.xorshift64star(torch.tensor([12345], dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 62 + 17])
def test_fast_random_sequence(seed):
    j, t = jfm.FastRandom(seed), tfm.FastRandom(seed)
    assert [j.next_uint64() for _ in range(50)] == [
        t.next_uint64() for _ in range(50)]
    assert [j.float64() for _ in range(20)] == [t.float64()
                                               for _ in range(20)]
    assert [j.int_range(-5, 17) for _ in range(20)] == [
        t.int_range(-5, 17) for _ in range(20)]
    assert j.float64_range(2.0, 3.0) == t.float64_range(2.0, 3.0)
    # the tensor step of the generator's state is the generator's step
    r = tfm.FastRandom(seed)
    st = torch.tensor([r.state - (1 << 64) if r.state >= 1 << 63
                       else r.state], dtype=torch.int64)
    _, out = tfm.xorshift64star(st)
    assert int(out[0]) & 0xFFFFFFFFFFFFFFFF == r.next_uint64()


def _x(lo, hi, n=97, seed=1):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


UNARY = {
    "fast_sqrt": (0.0, 50.0), "fast_cbrt": (-20.0, 20.0),
    "fast_exp": (-5.0, 5.0), "fast_log": (0.01, 50.0),
    "fast_log2": (0.01, 50.0), "fast_log10": (0.01, 50.0),
    "fast_sin": (-6.0, 6.0), "fast_cos": (-6.0, 6.0),
    "fast_tan": (-1.2, 1.2), "fast_asin": (-1.0, 1.0),
    "fast_acos": (-1.0, 1.0), "fast_atan": (-9.0, 9.0),
    "fast_sinh": (-3.0, 3.0), "fast_cosh": (-3.0, 3.0),
    "fast_tanh": (-3.0, 3.0), "fast_floor": (-9.0, 9.0),
    "fast_ceil": (-9.0, 9.0), "fast_round": (-9.0, 9.0),
    "fast_abs": (-9.0, 9.0), "fast_inv_sqrt": (0.01, 50.0),
    "fast_sign": (-2.0, 2.0), "fast_fract": (-9.0, 9.0),
    "fast_radians": (-360.0, 360.0), "fast_degrees": (-7.0, 7.0),
}
BINARY = {
    "fast_pow": ((0.1, 4.0), (-2.0, 3.0)), "fast_atan2": ((-5, 5), (-5, 5)),
    "fast_mod": ((-9, 9), (0.5, 3.0)), "fast_min": ((-5, 5), (-5, 5)),
    "fast_max": ((-5, 5), (-5, 5)), "fast_hypot": ((-5, 5), (-5, 5)),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_wrappers(name):
    x = _x(*UNARY[name])
    if name == "fast_round":
        x[:8] = np.float32([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 0.0])
    want = np.asarray(getattr(jfm, name)(jnp.asarray(x)))
    got = getattr(tfm, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_wrappers(name):
    (a0, a1), (b0, b1) = BINARY[name]
    a, b = _x(a0, a1, seed=2), _x(b0, b1, seed=3)
    want = np.asarray(getattr(jfm, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tfm, name)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_scalar_helpers():
    x = _x(-0.5, 1.5)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (jfm.fast_clamp(jx, 0.2, 0.9), tfm.fast_clamp(tx, 0.2, 0.9)),
        (jfm.fast_lerp(jx, 3.0, 0.25), tfm.fast_lerp(tx, 3.0, 0.25)),
        (jfm.fast_smooth_step(0.1, 0.8, jx),
         tfm.fast_smooth_step(0.1, 0.8, tx)),
        (jfm.fast_smoother_step(0.1, 0.8, jx),
         tfm.fast_smoother_step(0.1, 0.8, tx)),
        (jfm.fast_step(0.3, jx), tfm.fast_step(0.3, tx)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(tfm.fast_smooth_step(0.0, 1.0, 0.5)),
                               0.5)
    np.testing.assert_allclose(tfm.fast_lerp(0.0, 10.0, 0.25), 2.5)


def _v(n=33, seed=4):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


VEC = {
    "vec3_add": lambda m, a, b, s: m.vec3_add(a, b),
    "vec3_sub": lambda m, a, b, s: m.vec3_sub(a, b),
    "vec3_mul": lambda m, a, b, s: m.vec3_mul(a, s),
    "vec3_div": lambda m, a, b, s: m.vec3_div(a, s),
    "vec3_dot": lambda m, a, b, s: m.vec3_dot(a, b),
    "vec3_cross": lambda m, a, b, s: m.vec3_cross(a, b),
    "vec3_length": lambda m, a, b, s: m.vec3_length(a),
    "vec3_length_squared": lambda m, a, b, s: m.vec3_length_squared(a),
    "vec3_normalize": lambda m, a, b, s: m.vec3_normalize(a),
    "vec3_reflect": lambda m, a, b, s: m.vec3_reflect(a, m.vec3_normalize(b)),
    "vec3_refract": lambda m, a, b, s: m.vec3_refract(
        m.vec3_normalize(a), m.vec3_normalize(b), 1.5),
    "vec3_distance": lambda m, a, b, s: m.vec3_distance(a, b),
    "vec3_lerp": lambda m, a, b, s: m.vec3_lerp(a, b, s),
}


@pytest.mark.parametrize("name", sorted(VEC))
def test_vec3_algebra(name):
    a, b = _v(seed=5), _v(seed=6)
    a[0] = 0.0  # the zero vector normalises to zero
    s = np.random.default_rng(7).uniform(0.5, 2.0, a.shape[0]).astype(
        np.float32)
    want = np.asarray(VEC[name](jfm, jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(s)))
    got = VEC[name](tfm, torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["1d", "2d", "3d", "fbm"])
def test_noise(name):
    x = np.linspace(-7.0, 10.0, 301).astype(np.float32)
    y, z = x * np.float32(0.7) + 0.3, x * np.float32(1.3) - 2.0
    args = {"1d": (x,), "2d": (x, y), "3d": (x, y, z), "fbm": (x, y, z)}[name]
    jf = {"1d": jfm.fast_noise_1d, "2d": jfm.fast_noise_2d,
          "3d": jfm.fast_noise_3d, "fbm": jfm.fbm_3d}[name]
    tf = {"1d": tfm.fast_noise_1d, "2d": tfm.fast_noise_2d,
          "3d": tfm.fast_noise_3d, "fbm": tfm.fbm_3d}[name]
    for seed in (0, 7):
        want = np.asarray(jf(*(jnp.asarray(a) for a in args), seed=seed))
        got = tf(*(torch.from_numpy(a) for a in args), seed=seed).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        assert got.min() >= 0.0 and got.max() < 1.0 and got.std() > 0.05


def test_number_theory():
    n = np.asarray([-7, 0, 1, 2, 3, 4, 17, 25, 97, 100, 7919, 7921])
    np.testing.assert_array_equal(tfm.is_prime(torch.from_numpy(n)).numpy(),
                                  np.asarray(jfm.is_prime(jnp.asarray(n))))
    with jax.enable_x64():
        fib = np.asarray(jfm.fibonacci(60))
    np.testing.assert_array_equal(tfm.fibonacci(60).numpy(), fib)
    p = np.asarray([121, 123, 7, 1221, 0, -121, 12321, 10, 1001])
    np.testing.assert_array_equal(
        tfm.is_palindrome_number(torch.from_numpy(p)).numpy(),
        np.asarray(jfm.is_palindrome_number(jnp.asarray(p))))
