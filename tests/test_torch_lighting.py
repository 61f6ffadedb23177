"""The port's lighting and emitters against the JAX package's
(raytrace_tpu.lighting, raytrace_tpu.effects_spectacular), on the CPU.

The four lights, phong, blinn_phong, ambient_occlusion,
AreaLight.integrate (with its visibility test) and one_bounce_indirect
(the port traces through megakernel.trace, on the CPU the eager engine;
the JAX function through its jnp engine) take the same seeded points,
normals and lane ids in both packages. Tolerance: atol 1e-5 (the same
float32 operations; a library pow or sin may round an ulp apart). The
ten emitters at atol 1e-5.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytrace_tpu as jrt
from raytrace_tpu import effects_spectacular as jspec
from raytrace_tpu import lighting as jl
from raytrace_tpu_torch import effects_spectacular as tspec
from raytrace_tpu_torch import lighting as tl
from raytrace_tpu_torch import scene as tscene
from test_torch_scene import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
CPU = "cpu"


def _pts(n=48, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def _ids(n):
    return (jnp.arange(n, dtype=jnp.uint32), jnp.zeros(n, jnp.uint32),
            torch.arange(n), torch.zeros(n, dtype=torch.int64))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _same_sample(got, want):
    for f in ("direction", "distance", "radiance"):
        _close(getattr(got, f), getattr(want, f))


LIGHTS = {
    "point": lambda m, **kw: m.PointLight([0.5, 3.0, -1.0], (1, 0.8, 0.6),
                                          2.0, **kw),
    "directional": lambda m, **kw: m.DirectionalLight([0.3, -1.0, 0.2],
                                                      (1, 1, 0.9), 1.5,
                                                      **kw),
    "area": lambda m, **kw: m.AreaLight([-1.0, 4.0, -1.0], [2, 0, 0],
                                        [0, 0, 2], (1, 1, 1), 3.0,
                                        samples=6, **kw),
    "spot": lambda m, **kw: m.SpotLight([0, 5, 0], [0.1, -1, 0],
                                        intensity=4.0, inner_cutoff_deg=20,
                                        outer_cutoff_deg=35, **kw),
}


@pytest.mark.parametrize("kind", sorted(LIGHTS))
def test_light_samples(kind):
    p = _pts()
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    jpix, jsamp, tpix, tsamp = _ids(p.shape[0])
    jlight = LIGHTS[kind](jl)
    tlight = LIGHTS[kind](tl, device=CPU)
    _same_sample(tlight.sample(tp), jlight.sample(jp))
    if kind == "area":  # one jittered draw a lane
        _same_sample(tlight.sample(tp, tpix, tsamp, 3, stream=5),
                     jlight.sample(jp, jpix, jsamp, 3, stream=5))


def test_light_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        tl.PointLight([0, 1, 0])


@pytest.mark.parametrize("model", ["phong", "blinn_phong"])
def test_shading_models(model):
    p, n = _pts(seed=1), _pts(seed=2)
    albedo = np.random.default_rng(3).uniform(0, 1, p.shape).astype(
        np.float32)
    jlight = jl.PointLight([0, 5, 0]).sample(jnp.asarray(p))
    tlight = tl.PointLight([0, 5, 0], device=CPU).sample(torch.from_numpy(p))
    want = getattr(jl, model)(jnp.asarray(n), -jnp.asarray(p), jlight,
                              jnp.asarray(albedo), shininess=16.0)
    got = getattr(tl, model)(torch.from_numpy(n), -torch.from_numpy(p),
                             tlight, torch.from_numpy(albedo),
                             shininess=16.0)
    _close(got, want)


def _scenes(simple_scene_dict):
    with open(os.path.join(ASSETS, "sphere_reflections_light.json")) as f:
        bench = json.load(f)
    bench["camera"]["position"][2] = -bench["camera"]["position"][2]
    return {"simple": simple_scene_dict, "bench": bench}


def _hit_points(d, n=40, seed=4):
    """Points around the spheres of a scene dict with normals: even lanes
    just above a sphere facing out, odd lanes half a unit off one facing
    it (so some rays are blocked and some hit)."""
    r = np.random.default_rng(seed)
    sph = [o for o in d["objects"] if o["type"] == "sphere"]
    k = r.integers(len(sph), size=n)
    nrm = r.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    c = np.asarray([sph[i]["position"] for i in k], np.float64)
    rad = np.asarray([sph[i]["radius"] for i in k], np.float64)
    odd = (np.arange(n) % 2 == 1)[:, None]
    p = c + nrm * (rad[:, None] + np.where(odd, 0.5, 1e-3))
    return p.astype(np.float32), np.where(odd, -nrm, nrm).astype(np.float32)


@pytest.mark.parametrize("name", ["simple", "bench"])
def test_ambient_occlusion_and_area_integrate(name, simple_scene_dict):
    d = _scenes(simple_scene_dict)[name]
    js, _ = jrt.scene_from_dict(d)
    ts, _ = tscene.from_dict(d, device=CPU)
    p, n = _hit_points(d)
    jpix, jsamp, tpix, tsamp = _ids(p.shape[0])
    want = jl.ambient_occlusion(js.geometry, jnp.asarray(p), jnp.asarray(n),
                                jpix, jsamp, samples=8, radius=2.0)
    got = tl.ambient_occlusion(ts.geometry, torch.from_numpy(p),
                               torch.from_numpy(n), tpix, tsamp, samples=8,
                               radius=2.0)
    _close(got, want)
    assert 0.0 < float(got.mean()) < 1.0
    al_j = LIGHTS["area"](jl)
    al_t = LIGHTS["area"](tl, device=CPU)
    want = al_j.integrate(jnp.asarray(p), jpix, jsamp, 1, 30,
                          geom=js.geometry)
    got = al_t.integrate(torch.from_numpy(p), tpix, tsamp, 1, 30,
                         geom=ts.geometry)
    _same_sample(got, want)
    free = al_t.integrate(torch.from_numpy(p), tpix, tsamp, 1, 30)
    assert float(got.radiance.sum()) < float(free.radiance.sum())


@pytest.mark.parametrize("name", ["simple", "bench"])
def test_one_bounce_indirect(name, simple_scene_dict):
    d = _scenes(simple_scene_dict)[name]
    js, _ = jrt.scene_from_dict(d)
    ts, _ = tscene.from_dict(d, device=CPU)
    p, n = _hit_points(d, n=32)
    jpix, jsamp, tpix, tsamp = _ids(p.shape[0])
    want = jl.one_bounce_indirect(js, jnp.asarray(p), jnp.asarray(n), jpix,
                                  jsamp, samples=3, seed=2)
    got = tl.one_bounce_indirect(ts, torch.from_numpy(p),
                                 torch.from_numpy(n), tpix, tsamp,
                                 samples=3, seed=2)
    _close(got, want)
    assert float(got.sum()) > 0.0


@pytest.mark.parametrize("name", sorted(jspec.ALL_EFFECTS))
def test_spectacular_emitters(name):
    p = _pts(64, seed=5) * np.float32(1.5)
    for t in (0.0, 0.37):
        want = jspec.ALL_EFFECTS[name](jnp.asarray(p), t=t)
        got = tspec.ALL_EFFECTS[name](torch.from_numpy(p), t=t)
        assert got.shape == (64, 3)
        _close(got, want)
    assert not torch.equal(tspec.ALL_EFFECTS[name](torch.from_numpy(p)),
                           tspec.ALL_EFFECTS[name](torch.from_numpy(p),
                                                   t=0.5))
