"""The port's procedural textures against raytrace_tpu.models.textures.

Each of the seven textures (Voronoi under its three distances) and the
fbm noise they share, at 4,096 random points made with numpy from a seed,
through the JAX package's texture and the port's, both built by their own
``texture_from_dict`` from the same scene-JSON block. Tolerances: colour
textures within 1e-6 absolute, scalar noise fields within 1e-5. Both run
the same float32 operations in the same order; XLA's and PyTorch's sin,
pow and three-term sums may round an ulp apart, and the fbm sums four
octaves of such values.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu import fastmath as jfm
from raytrace_tpu.models import textures as jtex
from raytrace_tpu_torch.models import textures as ttex

CASES = {
    "checkerboard": ({"type": "checkerboard", "scale": 0.8,
                      "color1": [0.85, 0.85, 0.9],
                      "color2": [0.15, 0.15, 0.2]}, 1e-6),
    "marble": ({"type": "marble", "scale": 4.0, "sharpness": 2.0,
                "baseColor": [0.9, 0.88, 0.82],
                "veinColor": [0.35, 0.3, 0.4]}, 1e-6),
    "marble-sharp1.7": ({"type": "marble", "scale": 1.3, "sharpness": 1.7},
                        1e-6),
    "wood": ({"type": "wood", "scale": 3.0, "ringWidth": 0.4}, 1e-6),
    "gradient": ({"type": "gradient", "direction": [1.0, 2.0, -0.5],
                  "color1": [0.1, 0.2, 0.3], "color2": [0.9, 0.5, 0.1]},
                 1e-6),
    "noise": ({"type": "noise", "scale": 2.5, "octaves": 5,
               "persistence": 0.6, "seed": 7}, 1e-5),
    "perlin": ({"type": "perlin", "scale": 1.5, "seed": 3}, 1e-5),
    "voronoi": ({"type": "voronoi", "scale": 1.2, "points": 24,
                 "seed": 5}, 1e-5),
    "voronoi-manhattan": ({"type": "voronoi", "distance": "manhattan",
                           "seed": 9}, 1e-5),
    "voronoi-chebyshev": ({"type": "voronoi", "distance": "chebyshev"},
                          1e-5),
}


def points(seed=0, n=4096):
    return np.random.default_rng(seed).uniform(-5.0, 5.0, (n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_texture_matches_jax(name):
    block, tol = CASES[name]
    jt, tt = jtex.texture_from_dict(block), ttex.texture_from_dict(block)
    assert type(tt).__name__ == type(jt).__name__
    p = points()
    ref = np.asarray(jt.value(jnp.asarray(p)))
    got = tt.value(torch.from_numpy(p)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    # the albedo binding: colours replace it, scalar fields scale it
    base = np.asarray([0.7, 0.5, 0.3], np.float32)
    ref_alb = np.asarray(jtex.textured_albedo(jt, jnp.asarray(p),
                                              jnp.asarray(base)))
    got_alb = ttex.textured_albedo(tt, torch.from_numpy(p),
                                   torch.from_numpy(base)).numpy()
    np.testing.assert_allclose(got_alb, ref_alb, rtol=0, atol=tol)


def test_fbm_matches_jax():
    p = points(1) * 3.0
    ref = np.asarray(jfm.fbm_3d(*(jnp.asarray(p[:, k]) for k in range(3)),
                                octaves=6, lacunarity=2.1, gain=0.45,
                                seed=11))
    got = ttex.fbm_3d(*(torch.from_numpy(p[:, k].copy()) for k in range(3)),
                      octaves=6, lacunarity=2.1, gain=0.45, seed=11)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # the lattice noise itself, which the kernels' fbm sums
    ref1 = np.asarray(jfm.fast_noise_3d(*(jnp.asarray(p[:, k])
                                          for k in range(3)), seed=4))
    got1 = ttex.fast_noise_3d(*(torch.from_numpy(p[:, k].copy())
                                for k in range(3)), seed=4)
    np.testing.assert_allclose(got1.numpy(), ref1, rtol=0, atol=1e-6)


def test_voronoi_feature_points_equal():
    for seed in (0, 5, 1234):
        tex = dict(scale=1.0, points=16, seed=seed)
        ref = np.asarray(jtex.VoronoiTexture(**tex)._feature_points())
        got = ttex.VoronoiTexture(**tex)._feature_points().numpy()
        np.testing.assert_array_equal(got, ref)


def test_texture_rows_layout():
    """The kernels' texture table: one row per binding, aux rows for the
    fbm octaves and the Voronoi feature points."""
    noise = ttex.NoiseTexture(octaves=3, persistence=0.6, seed=2)
    vor = ttex.VoronoiTexture(points=5)
    tab, aux = ttex.texture_rows(((1, noise), (4, vor)))
    assert tab.shape == (2, ttex.TEX_COLS) and aux.shape == (3 + 5, 3)
    assert tab[0, :2].tolist() == [1.0, 4.0]
    assert tab[1, :2].tolist() == [4.0, 6.0]
    assert tab[1, 4:6].tolist() == [3.0, 5.0]          # aux offset, count
    np.testing.assert_array_equal(aux[3:].numpy(),
                                  vor._feature_points().numpy())
    np.testing.assert_array_equal(
        aux[:3, :2].numpy(),
        np.float32([[1.0, 1.0], [0.6, 2.0], [0.36, 4.0]]))
