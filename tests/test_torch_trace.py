"""The port's plain engine against the JAX engine (raytrace_tpu.trace).

* Lane for lane: ~2k lanes per slice scene at depth 6 through
  raytrace_tpu.trace.trace and the port's trace.trace, same rays, same
  (pixel, sample) ids. Tolerance atol=1e-5: both engines run the same
  float32 operations in the same order; the one library function on the
  path, pow in the specular term, may round one ulp differently between
  XLA and PyTorch, which stays orders of magnitude below 1e-5.
* Goldens: the port's render_band against tests/goldens/*.npz for the
  three in-slice goldens, under the gate of tests/test_goldens.py:35-39
  (at most 0.1% of pixels off by more than 1e-3, mean abs error < 1e-4).
* Intersection: closest and any hit against raytrace_tpu.ops.intersect on
  random rays; exact, for the same reason as above.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import make_goldens
from raytrace_tpu import camera as jcam
from raytrace_tpu import rng as jrng
from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu.ops import intersect as jisect
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.ops import intersect as tisect

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
SLICE_ASSETS = ("sphere_reflections_light", "two_red_cubes_scene",
                "final_silver_prism_purple_cube")
SLICE_GOLDENS = ("spheres_metal_glass", "cubes_dielectric_plane",
                 "prism_perfectmirror")


def asset_dict(name):
    with open(os.path.join(ASSETS, f"{name}.json")) as f:
        d = json.load(f)
    d["camera"]["position"][2] = -d["camera"]["position"][2]
    return d


def camera_lanes(js, W, H, S):
    """JAX camera rays and uint32 ids of every lane of a W x H frame."""
    n = W * H
    pix = np.repeat(np.arange(n, dtype=np.uint32), S)
    samp = np.tile(np.arange(S, dtype=np.uint32), n)
    ju, jv, _, _ = jrng.uniform4(jnp.asarray(pix), jnp.asarray(samp),
                                 jrng.Streams.CAMERA_JITTER, 0)
    x = jnp.asarray((pix % W).astype(np.float32))
    y = jnp.asarray((pix // W).astype(np.float32))
    o, d = jcam.go_rays(js.camera, (x + ju) / W, (y + jv) / H)
    return np.asarray(o), np.asarray(d), pix, samp


@pytest.mark.parametrize("name", SLICE_ASSETS)
def test_trace_lane_for_lane(name):
    d = asset_dict(name)
    js, _ = jscene.from_dict(d)
    ts, _ = tscene.from_dict(d, device="cpu")
    o, dd, pix, samp = camera_lanes(js, 32, 32, 2)   # 2048 lanes
    ref = np.asarray(jtrace.trace(js, jnp.asarray(o), jnp.asarray(dd),
                                  jnp.asarray(pix), jnp.asarray(samp),
                                  jtrace.TraceConfig(max_depth=6)))
    got = ttrace.trace(ts, torch.from_numpy(o.copy()),
                       torch.from_numpy(dd.copy()),
                       torch.from_numpy(pix.astype(np.int64)),
                       torch.from_numpy(samp.astype(np.int64)),
                       ttrace.TraceConfig(max_depth=6)).numpy()
    assert (ref.sum(-1) > 0).any(), "the frame must see geometry"
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def render_golden(name):
    data, ck = {n: (d, c) for n, d, c in make_goldens.scenes()}[name]
    ts, _ = tscene.from_dict(data, device="cpu")
    cfg = ttrace.TraceConfig(seed=0, **ck)
    return ts, cfg, trender.render_band(
        ts, 0, width=make_goldens.W, height=make_goldens.H,
        band_h=make_goldens.H, samples=make_goldens.SPP, cfg=cfg).numpy()


def golden_gate(img, ref, name):
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.001, (
        f"{name}: {(diff > 1e-3).mean():.4f} of pixels moved >1e-3")
    assert float(np.abs(img - ref).mean()) < 1e-4


@pytest.mark.parametrize("name", SLICE_GOLDENS)
def test_render_band_meets_goldens_gate(name):
    ref = np.load(os.path.join(make_goldens.GOLDEN_DIR,
                               f"{name}.npz"))["linear"]
    _, _, img = render_golden(name)
    assert img.shape == ref.shape
    golden_gate(img, ref, name)


@pytest.fixture(scope="module")
def mixed_scene():
    """Spheres, a cube (box + 12 faces), a prism and a plane."""
    d = {n: d for n, d, _ in make_goldens.scenes()}["cubes_dielectric_plane"]
    d = json.loads(json.dumps(d))
    d["objects"].append({"type": "triangularPrism", "vertices": [
        [-1.0, 1.0, 0.5], [0.0, 2.0, 0.5], [1.0, 1.0, 0.5],
        [-1.0, 1.0, -0.5], [0.0, 2.0, -0.5], [1.0, 1.0, -0.5]]})
    return jscene.from_dict(d)[0], tscene.from_dict(d, device="cpu")[0]


def random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.normal(0.0, 3.0, (n, 3)).astype(np.float32)
    d = r.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    return o, d


def test_closest_hit_matches(mixed_scene):
    js, ts = mixed_scene
    o, d = random_rays(4096, 3)
    jh = jisect.closest_hit(js.geometry, jnp.asarray(o), jnp.asarray(d))
    th = tisect.closest_hit(ts.geometry, torch.from_numpy(o),
                            torch.from_numpy(d))
    assert th.hit.any() and (~th.hit).any()
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_array_equal(th.t.numpy(), np.asarray(jh.t))
    hit = th.hit.numpy()
    for name in ("point", "normal"):
        np.testing.assert_array_equal(getattr(th, name).numpy()[hit],
                                      np.asarray(getattr(jh, name))[hit])
    np.testing.assert_array_equal(th.front_face.numpy()[hit],
                                  np.asarray(jh.front_face)[hit])
    np.testing.assert_array_equal(th.mat_id.numpy()[hit],
                                  np.asarray(jh.mat_id)[hit])


@pytest.mark.parametrize("exact", [False, True])
def test_any_hit_matches(mixed_scene, exact):
    js, ts = mixed_scene
    o, d = random_rays(4096, 4)
    tmax = np.random.default_rng(5).uniform(0.1, 20.0, 4096).astype(
        np.float32)
    jb = jisect.any_hit(js.geometry, jnp.asarray(o), jnp.asarray(d), 1e-3,
                        jnp.asarray(tmax), exact=exact)
    tb = tisect.any_hit(ts.geometry, torch.from_numpy(o),
                        torch.from_numpy(d), 1e-3, torch.from_numpy(tmax),
                        exact=exact)
    assert tb.any() and (~tb).any()
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_out_of_slice_trace_options_raise(mixed_scene):
    _, ts = mixed_scene
    z = torch.zeros((1, 3))
    i = torch.zeros(1, dtype=torch.int64)
    for cfg in (ttrace.TraceConfig(depth_of_field=True),
                ttrace.TraceConfig(russian_roulette_start=8),
                ttrace.TraceConfig(throughput_epsilon=1e-4)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrace.trace(ts, z, z + 1.0, i, i, cfg)
