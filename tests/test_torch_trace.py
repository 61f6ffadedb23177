"""The port's plain engine against the JAX engine (raytrace_tpu.trace).

* Lane for lane: ~2k lanes per slice scene at depth 6 through
  raytrace_tpu.trace.trace and the port's trace.trace, same rays, same
  (pixel, sample) ids. Tolerance atol=1e-5: both engines run the same
  float32 operations in the same order; the one library function on the
  path, pow in the specular term, may round one ulp differently between
  XLA and PyTorch, which stays orders of magnitude below 1e-5.
* Goldens: the port's render_band against tests/goldens/*.npz for the
  five goldens of the ported slices (the extended kinds with a texture,
  and the smooth-shaded icosphere mesh, among them), under the gate of
  tests/test_goldens.py:35-39 (at most 0.1% of pixels off by more than
  1e-3, mean abs error < 1e-4); the port's render_wavefront in bvh mode
  against bvh_ring.npz under test_golden_bvh's gate (tests/
  test_goldens.py:53-57: at most 1% of pixels off by more than 1e-3).
* The Go oracle: the port's trace.trace against tests/go_oracle.Oracle on
  the deterministic scenes and ray grid of tests/test_trace.py (the metal
  scene at depths 50, 1, 2, 5 and without recursion; the lambertian
  sphere), with that file's tolerances (float32 against float64).
* The main path: render_wavefront equals render_band under the goldens
  gate on the three new assets (their look-at cameras) and on a
  loop-mode scene, and max_depth 100 with 20 lights and 80 soft-shadow
  samples renders.
* Intersection: closest and any hit against raytrace_tpu.ops.intersect on
  random rays; exact, for the same reason as above.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import go_oracle
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
from test_torch_scene import one_torch_thread  # noqa: F401

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
SLICE_ASSETS = ("sphere_reflections_light", "two_red_cubes_scene",
                "final_silver_prism_purple_cube")
SLICE_GOLDENS = ("spheres_metal_glass", "cubes_dielectric_plane",
                 "prism_perfectmirror", "extended_textured",
                 "mesh_smooth_icosphere")


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


def slice_dict(name):
    """A scene of this slice as a dict: an asset with its camera on +Z
    (the go camera looks down -Z), or a golden scene."""
    gold = {n: d for n, d, _ in make_goldens.scenes()}
    if name in gold:
        return json.loads(json.dumps(gold[name]))
    with open(os.path.join(ASSETS, f"{name}.json")) as f:
        d = json.load(f)
    d["camera"]["position"][2] = abs(d["camera"]["position"][2])
    return d


@pytest.mark.parametrize("name", ["mesh_demo", "smooth_shading_demo",
                                  "textured_mirror_demo", "extended_textured",
                                  "mesh_smooth_icosphere"])
def test_trace_lane_for_lane_slice(name):
    """The same comparison on the scenes of the third slice (meshes,
    vertex normals, kinds 7-12, textures), 512 lanes each, brute force:
    the JAX engine's tree walk compiles for half a minute, and the walks
    are held to it in tests/test_torch_bvh.py."""
    d = slice_dict(name)
    js, _ = jscene.from_dict(d, base_dir=ASSETS, build_accel=False)
    ts, _ = tscene.from_dict(d, device="cpu", base_dir=ASSETS,
                             build_accel=False)
    o, dd, pix, samp = camera_lanes(js, 16, 16, 2)
    ref = np.asarray(jtrace.trace(js, jnp.asarray(o), jnp.asarray(dd),
                                  jnp.asarray(pix), jnp.asarray(samp),
                                  jtrace.TraceConfig(max_depth=6,
                                                     shadow_samples=4)))
    got = ttrace.trace(ts, torch.from_numpy(o.copy()),
                       torch.from_numpy(dd.copy()),
                       torch.from_numpy(pix.astype(np.int64)),
                       torch.from_numpy(samp.astype(np.int64)),
                       ttrace.TraceConfig(max_depth=6,
                                          shadow_samples=4)).numpy()
    assert (ref.sum(-1) > 0).mean() > 0.2, "the frame must see geometry"
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


def test_trace_options_fast_mc_and_dof(mixed_scene):
    """The trace options that rode on later slices run: depth of field
    (applied to the camera rays, so the trace itself is unchanged) and
    both parts of fast_mc, which end lanes early."""
    _, ts = mixed_scene
    o, d = random_rays(512, 11)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    i = torch.arange(512)
    base = ttrace.TraceConfig(max_depth=6, shadow_samples=2)
    ref = ttrace.trace(ts, o, d, i, i, base)
    got = ttrace.trace(ts, o, d, i, i, ttrace.TraceConfig(
        max_depth=6, shadow_samples=2, depth_of_field=True))
    assert torch.equal(got, ref)
    for cfg in (ttrace.TraceConfig(max_depth=6, shadow_samples=2,
                                   russian_roulette_start=1),
                ttrace.TraceConfig(max_depth=6, shadow_samples=2,
                                   throughput_epsilon=0.2)):
        got = ttrace.trace(ts, o, d, i, i, cfg)
        assert torch.isfinite(got).all() and not torch.equal(got, ref)


def test_render_wavefront_meets_bvh_golden():
    ref = np.load(os.path.join(make_goldens.GOLDEN_DIR,
                               "bvh_ring.npz"))["linear"]
    data, ck = make_goldens.bvh_scene()
    ts, _ = tscene.from_dict(data, device="cpu")
    from raytrace_tpu_torch.ops import megakernel as tmk
    assert tmk._kernel_mode(ts) == "bvh"
    img = trender.render_wavefront(
        ts, width=make_goldens.BVH_W, height=make_goldens.BVH_H,
        samples=make_goldens.BVH_SPP,
        cfg=ttrace.TraceConfig(seed=0, **ck)).numpy()
    assert img.shape == ref.shape
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01
    assert float(np.abs(img - ref).mean()) < 1e-4


# tests/test_trace.py's deterministic scenes
METAL_SCENE = {
    "camera": {"position": [0, 0, 6], "aspectRatio": 1.33},
    "objects": [
        {"type": "sphere", "position": [0, 0, 0], "radius": 1.2,
         "material": {"type": "metal", "color": [0.8, 0.8, 0.9],
                      "roughness": 0.0, "metallic": 1.0}},
        {"type": "sphere", "position": [2.2, 0.5, -1], "radius": 0.8,
         "material": {"type": "metal", "color": [0.9, 0.5, 0.2],
                      "roughness": 0.0, "metallic": 0.6}},
        {"type": "sphere", "position": [-2, -0.5, 1], "radius": 0.6,
         "material": {"type": "diffuselight", "color": [2, 1.5, 1]}},
    ],
    "lights": [
        {"type": "point", "position": [4, 5, 6], "color": [1, 1, 1],
         "intensity": 3.0},
        {"type": "point", "position": [-4, 2, 5], "color": [0.9, 0.8, 1],
         "intensity": 1.5},
    ],
}
LAMBERT_SCENE = {
    "camera": {"position": [0, 0, 3], "aspectRatio": 1.0},
    "objects": [{"type": "sphere", "position": [0, 0, 0], "radius": 1.0,
                 "material": {"type": "lambertian",
                              "color": [0.5, 0.6, 0.7]}}],
    "lights": [{"type": "point", "position": [0, 5, 5],
                "color": [1, 1, 1], "intensity": 2.0}],
}
# (scene, depth, recursive, grid, oracle options, rtol, atol)
ORACLE_CASES = {
    "metal-d50": (METAL_SCENE, 50, True, (12, 9), {}, 2e-3, 2e-4),
    "metal-d1": (METAL_SCENE, 1, True, (6, 4), {}, 2e-3, 2e-4),
    "metal-d2": (METAL_SCENE, 2, True, (6, 4), {}, 2e-3, 2e-4),
    "metal-d5": (METAL_SCENE, 5, True, (6, 4), {}, 2e-3, 2e-4),
    "metal-norecursion": (METAL_SCENE, 50, False, (6, 4), {}, 2e-3, 2e-4),
    "lambertian": (LAMBERT_SCENE, 50, True, (10, 10),
                   {"lambertian_terminal": True}, 1e-3, 1e-5),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_trace_matches_go_oracle(case):
    data, depth, rec, (nu, nv), okw, rtol, atol = ORACLE_CASES[case]
    ts, _ = tscene.from_dict(data, device="cpu")
    us, vs = np.meshgrid(np.linspace(0.05, 0.95, nu),
                         np.linspace(0.05, 0.95, nv))
    from raytrace_tpu_torch import camera as tcam
    o, d = tcam.go_rays(ts.camera, torch.tensor(us.ravel(), dtype=torch.float32),
                        torch.tensor(vs.ravel(), dtype=torch.float32))
    pix = torch.arange(nu * nv)
    cfg = ttrace.TraceConfig(max_depth=depth, soft_shadows=False,
                             recursive_reflections=rec)
    mine = ttrace.trace(ts, o.contiguous(), d, pix, torch.zeros_like(pix),
                        cfg).numpy()
    orc = go_oracle.Oracle(data, max_depth=depth, soft_shadows=False,
                           recursive_reflections=rec, **okw)
    theirs = np.stack([orc.trace(*orc.get_ray(float(u), float(v)))
                       for u, v in zip(us.ravel(), vs.ravel())])
    if (nu, nv) != (6, 4):  # tests/test_trace.py's coarse grids see sky
        assert (theirs.sum(-1) > 0).any()
    np.testing.assert_allclose(mine, theirs, rtol=rtol, atol=atol)


def slice_scene(name):
    """A scene of this slice on the CPU: an asset from its file (look-at
    camera), or the icosphere golden without its BVH (loop mode)."""
    if name == "icosphere-loop":
        data = {n: d for n, d, _ in make_goldens.scenes()}[
            "mesh_smooth_icosphere"]
        return tscene.from_dict(data, device="cpu", build_accel=False)[0], True
    return tscene.load(os.path.join(ASSETS, f"{name}.json"),
                       device="cpu")[0], False


@pytest.mark.parametrize("name", ["mesh_demo", "smooth_shading_demo",
                                  "textured_mirror_demo", "icosphere-loop"])
def test_wavefront_equals_dense_slice(name):
    from raytrace_tpu_torch.ops import megakernel as tmk
    ts, go = slice_scene(name)
    assert tmk._kernel_mode(ts) == {"smooth_shading_demo": "bvh",
                                    "icosphere-loop": "loop"}.get(
                                        name, "unroll")
    cfg = ttrace.TraceConfig(max_depth=6, shadow_samples=4)
    kw = dict(width=40, height=30, samples=3, cfg=cfg, go_camera=go)
    wf = trender.render_wavefront(ts, **kw).numpy()
    dense = trender.render_band(ts, 0, band_h=30, **kw).numpy()
    assert (dense.sum(-1) > 0).mean() > 0.3
    golden_gate(wf, dense, name)


def test_run_time_bounds_render():
    """max_depth 100, 20 lights and 80 soft-shadow samples: settings past
    what the CUDA path took before; the plain path renders them."""
    d = {n: d for n, d, _ in make_goldens.scenes()}["prism_perfectmirror"]
    d = json.loads(json.dumps(d))
    d["lights"] = [{"position": [4 - 0.4 * i, 6, 5 - 0.3 * i],
                    "color": [1, 1, 1], "intensity": 3.0} for i in range(20)]
    ts, _ = tscene.from_dict(d, device="cpu")
    cfg = ttrace.TraceConfig(max_depth=100, shadow_samples=80)
    img = trender.render_wavefront(ts, width=4, height=3, samples=1,
                                   cfg=cfg)
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0
