"""The port's counter RNG against raytrace_tpu.rng: bit-equal.

Inputs are random (pixel, sample, stream, seed) uint32 values from a
numpy seed. Tolerance: none - the hash is integer arithmetic and the
float draws use the same float32 operations in the same order (and a
correctly rounded square root), so every output must match bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu import rng as jrng
from raytrace_tpu_torch import rng as trng

N = 4096


@pytest.fixture(scope="module")
def ids():
    r = np.random.default_rng(1234)
    draw = lambda: r.integers(0, 2**32, N, dtype=np.uint64).astype(
        np.uint32)
    return draw(), draw(), draw(), draw()


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def test_pcg4d_bit_equal(ids):
    j = jrng.pcg4d(*(jnp.asarray(a) for a in ids))
    t = trng.pcg4d(*(_t(a) for a in ids))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())


@pytest.mark.parametrize("stream,seed", [(0, 0), (1, 7), (513, 0),
                                         (2**32 - 1, 2**31 + 5)])
def test_uniform4_bit_equal(ids, stream, seed):
    pix, samp = ids[0], ids[1]
    j = jrng.uniform4(jnp.asarray(pix), jnp.asarray(samp), stream, seed)
    t = trng.uniform4(_t(pix), _t(samp), stream, seed)
    for a, b in zip(j, t):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", ["unit_ball", "unit_disk"])
def test_samplers_bit_equal(ids, name):
    pix, samp = ids[0], ids[1]
    for stream in (1, 8 + 3 * 17, 49 * 512 + 2):
        j = getattr(jrng, name)(jnp.asarray(pix), jnp.asarray(samp), stream,
                                3)
        t = getattr(trng, name)(_t(pix), _t(samp), stream, 3)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_sincos_and_cbrt_bit_equal():
    u = np.random.default_rng(7).random(N).astype(np.float32)
    u[:4] = [0.0, 0.25, 0.5, np.float32(1.0) - np.float32(2**-24)]
    js, jc = jrng.sincos_2pi(jnp.asarray(u))
    ts, tc = trng.sincos_2pi(torch.from_numpy(u))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jrng.cbrt01(jnp.asarray(u))),
                                  trng.cbrt01(torch.from_numpy(u)).numpy())


def test_stream_ids_match():
    assert trng.STREAMS_PER_BOUNCE == jrng.STREAMS_PER_BOUNCE
    for name in ("CAMERA_JITTER", "SCATTER_BALL", "DIELECTRIC",
                 "RUSSIAN_ROULETTE", "DOF_DISK", "SHADOW_BASE"):
        assert getattr(trng.Streams, name) == getattr(jrng.Streams, name)
    for li, s, n in ((0, 0, 16), (1, 15, 16), (3, 2, 8)):
        assert (trng.shadow_stream(li, s, n)
                == jrng.shadow_stream(li, s, n))
        assert trng.bounce_stream(49, s) == jrng.bounce_stream(49, s)
