"""The port's ray utilities and geometry queries against the JAX package's
(raytrace_tpu.rays, raytrace_tpu.models.geometry_extras).

Every function runs on the same seeded inputs in both packages, with the
quirks the JAX docstrings name included (the projection that
distance_to_point returns, scale's normalised direction, the ray at the
origin that is_valid rejects, the scrambled contains test and its vertex
fallback, the one-cap lens volume). Tolerance: atol 1e-6 (with rtol 1e-6
for the values far from 1); booleans exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu import rays as jrays
from raytrace_tpu.models import geometry_extras as jgx
from raytrace_tpu_torch import rays as trays
from raytrace_tpu_torch.models import geometry_extras as tgx

TOL = dict(rtol=1e-6, atol=1e-6)
N = 41


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    v = lambda: r.normal(size=(N, 3)).astype(np.float32)
    o, d, p, o2, d2 = v(), v(), v(), v(), v()
    o[0] = 0.0                 # a ray at the origin: invalid
    d[1] = 0.0                 # a zero direction
    d[2], d2[2] = [0.0, 1.5, 0.0], [0.0, -3.0, 0.0]  # parallel rays
    p[3] = o[3] + 0.7 * d[3]   # a point on its ray
    d2[4] = np.cross(d[4], [0.0, 0.0, 1.0]).astype(np.float32)
    d2[4] = np.cross(d2[4], d[4]).astype(np.float32)  # perpendicular
    t = r.uniform(-2, 3, N).astype(np.float32)
    ang = r.uniform(-3, 3, N).astype(np.float32)
    axis = r.normal(size=(N, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return dict(o=o, d=d, p=p, o2=o2, d2=d2, t=t, ang=ang, axis=axis)


RAYS = {
    "at": lambda m, x: m.at(x["o"], x["d"], x["t"]),
    "point_at_distance": lambda m, x: m.point_at_distance(x["o"], x["d"],
                                                          x["t"]),
    "distance_to_point": lambda m, x: m.distance_to_point(x["o"], x["d"],
                                                          x["p"]),
    "closest_point_on_ray": lambda m, x: m.closest_point_on_ray(
        x["o"], x["d"], x["p"]),
    "distance_to_point_squared": lambda m, x: m.distance_to_point_squared(
        x["o"], x["d"], x["p"]),
    "is_point_on_ray": lambda m, x: m.is_point_on_ray(x["o"], x["d"],
                                                      x["p"], 1e-3),
    "rotate": lambda m, x: m.rotate(x["o"], x["d"], x["axis"], x["ang"]),
    "translate": lambda m, x: m.translate(x["o"], x["d"], x["p"]),
    "scale": lambda m, x: m.scale(x["o"], x["d"], 2.5),
    "bounding_box": lambda m, x: m.bounding_box(x["o"], x["d"]),
    "length": lambda m, x: m.length(x["d"]),
    "is_valid": lambda m, x: m.is_valid(x["o"], x["d"]),
    "is_parallel": lambda m, x: m.is_parallel(x["d"], x["d2"]),
    "is_perpendicular": lambda m, x: m.is_perpendicular(x["d"], x["d2"]),
    "angle": lambda m, x: m.angle(x["d"], x["d2"]),
    "distance_to_ray": lambda m, x: m.distance_to_ray(x["o"], x["d"],
                                                      x["o2"], x["d2"]),
}


def _pair(want, got):
    if isinstance(want, tuple):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            _pair(w, g)
        return
    want, got = np.asarray(want), got.numpy()
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(RAYS))
def test_rays(name):
    x = _inputs()
    if name == "distance_to_point":  # the quirk: a projection
        x["p"][5] = x["o"][5] - 3.0 * x["d"][5]
    want = RAYS[name](jrays, {k: jnp.asarray(v) for k, v in x.items()})
    got = RAYS[name](trays, {k: torch.from_numpy(v) for k, v in x.items()})
    _pair(want, got)
    if name == "is_valid":
        assert not bool(got[0]) and not bool(got[1]) and bool(got[5])
    if name == "is_parallel":
        assert bool(got[2])
    if name == "distance_to_point":
        assert float(got[5]) < 0.0
    if name == "scale":
        np.testing.assert_allclose(torch.linalg.vector_norm(
            got[1][2:], dim=-1).numpy(), 1.0, rtol=1e-6)


def _geo(seed=1):
    r = np.random.default_rng(seed)
    v = lambda: r.normal(size=(N, 3)).astype(np.float32)
    c1, c2, p, v0, v1, v2 = v(), v(), v(), v(), v(), v()
    r1 = r.uniform(0.2, 2.0, N).astype(np.float32)
    r2 = r.uniform(0.2, 2.0, N).astype(np.float32)
    p[0] = c1[0]                       # the center: closest point quirk
    c2[1] = c1[1] + [0.1, 0.0, 0.0]    # one sphere holds the other
    r1[1], r2[1] = 2.0, 0.5
    c2[2] = c1[2] + [0.5, 0.0, 0.0]    # equal radii, partial overlap
    r1[2] = r2[2] = 1.0
    p[3] = (v0[3] + v1[3] + v2[3]) / 3.0  # the centroid
    return dict(c1=c1, c2=c2, r1=r1, r2=r2, p=p, v0=v0, v1=v1, v2=v2)


GEO = {
    "sphere_surface_area": lambda m, x: m.sphere_surface_area(x["r1"]),
    "sphere_volume": lambda m, x: m.sphere_volume(x["r1"]),
    "sphere_contains_point": lambda m, x: m.sphere_contains_point(
        x["c1"], x["r1"], x["p"]),
    "sphere_closest_point": lambda m, x: m.sphere_closest_point(
        x["c1"], x["r1"], x["p"]),
    "sphere_distance_to_point": lambda m, x: m.sphere_distance_to_point(
        x["c1"], x["r1"], x["p"]),
    "sphere_normal_at_point": lambda m, x: m.sphere_normal_at_point(
        x["c1"], x["p"]),
    "spheres_intersect": lambda m, x: m.spheres_intersect(
        x["c1"], x["r1"], x["c2"], x["r2"]),
    "sphere_intersection_volume": lambda m, x: m.sphere_intersection_volume(
        x["c1"], x["r1"], x["c2"], x["r2"]),
    "triangle_bounding_box": lambda m, x: m.triangle_bounding_box(
        x["v0"], x["v1"], x["v2"]),
    "triangle_area": lambda m, x: m.triangle_area(x["v0"], x["v1"],
                                                  x["v2"]),
    "triangle_centroid": lambda m, x: m.triangle_centroid(
        x["v0"], x["v1"], x["v2"]),
    "triangle_contains_point": lambda m, x: m.triangle_contains_point(
        x["v0"], x["v1"], x["v2"], x["p"]),
    "triangle_closest_point": lambda m, x: m.triangle_closest_point(
        x["v0"], x["v1"], x["v2"], x["p"]),
    "triangle_distance_to_point": lambda m, x: m.triangle_distance_to_point(
        x["v0"], x["v1"], x["v2"], x["p"]),
}


@pytest.mark.parametrize("name", sorted(GEO))
def test_geometry_extras(name):
    x = _geo()
    want = GEO[name](jgx, {k: jnp.asarray(v) for k, v in x.items()})
    got = GEO[name](tgx, {k: torch.from_numpy(v) for k, v in x.items()})
    _pair(want, got)
    if name == "sphere_closest_point":   # the zero-normalise quirk
        np.testing.assert_array_equal(got[0].numpy(), x["c1"][0])


def test_geometry_extras_take_lists():
    """Python numbers and lists, as the JAX functions take them."""
    assert bool(tgx.sphere_contains_point([0.0, 0, 0], 1.0, [1.0, 0, 0]))
    np.testing.assert_allclose(
        tgx.sphere_intersection_volume([0.0, 0, 0], 1.0, [1.0, 0, 0],
                                       1.0).numpy(),
        np.asarray(jgx.sphere_intersection_volume([0.0, 0, 0], 1.0,
                                                  [1.0, 0, 0], 1.0)),
        **TOL)
