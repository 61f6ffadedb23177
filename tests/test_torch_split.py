"""K1-state and the split ladder of the port against the JAX package, on
the CPU.

* K1-state's plain version (trace.trace with start_bounce/end_bounce,
  init_throughput/init_alive and return_state) against the JAX package's
  trace_pallas(..., start_bounce=0, end_bounce=2, return_state=True,
  interpret=True) on 96 lanes in unroll mode (one interpret call): the
  same alive flags, the radiance within 1e-6 and the state of the alive
  lanes within 2e-6 (a few ulps of origins of magnitude 1-4: the Pallas
  kernel normalises with rsqrt, which rounds differently from the plain
  division - the reason tests/test_torch_megakernel.py holds K1 to 1e-4).
* Resuming: [0,b) with state and then [b,D) from it sums to the [0,D)
  radiance within 1e-6 (one float add) in all four kernel modes, the
  state's alive flags are the lanes that [b,D) still traces, and a lane
  that starts dead stays dead with radiance 0.
* trace_with_split with both deep-capacity policies equals the unsplit
  trace within 1e-6 and reports no overflow; a forced one-lane capacity
  reports overflow; render_wavefront then blacklists the configuration
  and its frame equals the unsplit frame.
* pick_split, pick_deep_caps, _auto_surv_cap and _split_levels equal the
  JAX functions on grid-5833, ico-10241 and a bvh scene, with the JAX
  package's RT_* variables unset; pick_deep_caps counts the material ids
  of every geometry table (planes and boxes too, a parity departure),
  which gives the JAX verdict on those scenes and "const" where the JAX
  package says "shrink" on a stream scene whose glass is in cubes.
"""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import make_goldens

from raytrace_tpu import renderer as jrender
from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu.ops import megakernel as jmk
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench import suite
from raytrace_tpu_torch.ops import megakernel as tmk
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_trace import camera_lanes


def as_torch(o, d, pix, samp):
    t = lambda a: torch.from_numpy(np.array(a))
    return (t(o), t(d), t(pix.astype(np.int64)), t(samp.astype(np.int64)))


def stream_dict():
    """A sphere, cube and plane scene small enough to force into stream
    mode (the recipe of tests/test_megakernel.py:281)."""
    objs = []
    for i in range(20):
        a = 2 * math.pi * i / 20
        objs.append({"type": "sphere",
                     "position": [5 * math.cos(a), 0.5,
                                  5 * math.sin(a) - 6], "radius": 0.6,
                     "material": {"type": ["lambertian", "metal",
                                           "glass"][i % 3],
                                  "color": [0.6, 0.4, 0.3],
                                  "roughness": 0.2}})
    objs.append({"type": "cube", "position": [0, 0, -6],
                 "size": [1.5, 1.5, 1.5],
                 "material": {"type": "lambertian",
                              "color": [0.3, 0.5, 0.7]}})
    objs.append({"type": "plane", "position": [0, -1.2, 0],
                 "normal": [0, 1, 0],
                 "material": {"type": "lambertian",
                              "color": [0.5, 0.5, 0.5]}})
    return {"camera": {"position": [0, 1, 3], "aspectRatio": 1.33},
            "objects": objs,
            "lights": [{"type": "point", "position": [4, 8, 4],
                        "color": [1, 1, 1], "intensity": 2.0}]}


@pytest.fixture
def stream_scene(monkeypatch):
    """stream_dict on a leaf-4 tree, forced into stream mode."""
    monkeypatch.setattr(tmk, "UNROLL_PRIM_LIMIT", 4)
    monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 8)
    ts = tscene.with_accel(tscene.from_dict(stream_dict(), device="cpu")[0],
                           leaf_size=4)
    assert tmk._kernel_mode(ts) == "stream"
    return ts


def test_state_matches_trace_pallas():
    d = filled_golden()
    js = jscene.from_dict(d)[0]
    ts = tscene.from_dict(d, device="cpu")[0]
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(js) == "unroll"
    o, dd, pix, samp = camera_lanes(js, 12, 8, 1)
    jcfg = jtrace.TraceConfig(max_depth=6, shadow_samples=2)
    jrad, jst = jmk.trace_pallas(
        js, jnp.asarray(o), jnp.asarray(dd), jnp.asarray(pix),
        jnp.asarray(samp), jcfg, start_bounce=0, end_bounce=2,
        return_state=True, interpret=True)
    rad, st = ttrace.trace(ts, *as_torch(o, dd, pix, samp),
                           ttrace.TraceConfig(max_depth=6, shadow_samples=2),
                           start_bounce=0, end_bounce=2, return_state=True)
    alive = np.asarray(jst["alive"]) > 0
    assert 0.1 < alive.mean() < 1.0
    np.testing.assert_array_equal(st["alive"].numpy(),
                                  np.asarray(jst["alive"]))
    for k in ("origin", "direction", "throughput"):
        np.testing.assert_allclose(st[k].numpy()[alive],
                                   np.asarray(jst[k])[alive], rtol=0,
                                   atol=2e-6, err_msg=k)
    np.testing.assert_allclose(rad.numpy(), np.asarray(jrad), rtol=0,
                               atol=1e-6)


def resume(ts, lanes, cfg, b):
    """([0,b) radiance, state, [b,D) radiance from the state)."""
    ra, st = tmk.trace(ts, *lanes, cfg, end_bounce=b, return_state=True)
    rb = tmk.trace(ts, st["origin"], st["direction"], *lanes[2:], cfg,
                   start_bounce=b, init_throughput=st["throughput"],
                   init_alive=st["alive"])
    return ra, st, rb


def filled_golden():
    """cubes_dielectric_plane with its camera moved to fill the frame."""
    d = {n: d for n, d, _ in make_goldens.scenes()}["cubes_dielectric_plane"]
    d["camera"]["position"] = [0, 1, 3]
    return d


@pytest.mark.parametrize("mode", ["unroll", "bvh", "stream", "loop"])
def test_resume_equals_whole(mode, monkeypatch):
    d = filled_golden() if mode == "unroll" else suite.mixed_scene_dict()
    if mode == "stream":
        monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 8)
    ts = tscene.from_dict(d, device="cpu",
                          build_accel=False if mode == "loop" else None)[0]
    assert tmk._kernel_mode(ts) == mode
    lanes = as_torch(*camera_lanes(jscene.from_dict(d)[0], 12, 8, 2))
    cfg = ttrace.TraceConfig(max_depth=12, shadow_samples=2)
    whole = tmk.trace(ts, *lanes, cfg)
    ra, st, rb = resume(ts, lanes, cfg, 3)
    torch.testing.assert_close(ra + rb, whole, rtol=0, atol=1e-6)
    # the lanes the state calls alive are the ones [3,D) still traces
    dead = st["alive"] == 0
    assert dead.any() and (~dead).any()
    assert not rb[dead].any()
    # a lane that starts dead stays dead and gives 0
    rc, sc = tmk.trace(ts, *lanes, cfg, init_alive=torch.zeros(
        lanes[0].shape[0]), return_state=True)
    assert not rc.any() and not sc["alive"].any()


@pytest.mark.parametrize("deep_caps", ["const", "shrink"])
def test_trace_with_split_matches_unsplit(stream_scene, deep_caps):
    js = jscene.from_dict(stream_dict())[0]
    lanes = as_torch(*camera_lanes(js, 12, 8, 2))
    cfg = ttrace.TraceConfig(max_depth=16, shadow_samples=2)
    whole = tmk.trace(stream_scene, *lanes, cfg)
    rad, ov = trender.trace_with_split(
        stream_scene, *lanes, cfg, split=(2, 4, 7, 11),
        surv_cap=trender._auto_surv_cap(lanes[0].shape[0]),
        deep_caps=deep_caps)
    assert int(ov) == 0
    torch.testing.assert_close(rad, whole, rtol=0, atol=1e-6)
    _, ov = trender.trace_with_split(stream_scene, *lanes, cfg,
                                     split=(2, 4), surv_cap=1,
                                     deep_caps=deep_caps)
    assert int(ov) > 0


def test_overflow_redoes_the_frame_unsplit(stream_scene, monkeypatch):
    cfg = ttrace.TraceConfig(max_depth=12, shadow_samples=2)
    kw = dict(width=12, height=8, samples=2, cfg=cfg)
    key = (12, 8, 2, cfg, True)
    seen = []
    hook = lambda stage, **v: seen.append(v["overflow"]) if (
        stage == "overflow") else None
    split_img = trender.render_wavefront(stream_scene, **kw, hook=hook)
    assert seen == [0] and key not in trender._SPLIT_BLACKLIST
    monkeypatch.setattr(trender, "SURV_FRAC", 1 << 30)
    monkeypatch.setattr(trender, "SPLIT_QUANTUM", 1)
    try:
        img = trender.render_wavefront(stream_scene, **kw, hook=hook)
        assert seen[-1] > 0 and key in trender._SPLIT_BLACKLIST
        unsplit = trender.render_wavefront(stream_scene, **kw, hook=hook)
    finally:
        trender._SPLIT_BLACKLIST.discard(key)
    assert len(seen) == 2  # the blacklisted frame renders unsplit
    assert torch.equal(img, unsplit)
    torch.testing.assert_close(split_img, unsplit, rtol=0, atol=1e-6)
    dense = trender.render_band(stream_scene, 0, band_h=8, **kw)
    torch.testing.assert_close(split_img, dense, rtol=0, atol=1e-6)


def box_glass_scene_dict():
    """A stream scene (4,940 primitives) whose glass is in cubes: 4,700
    lambertian spheres and 20 glass cubes. Counting the cubes' faces
    alone, as the JAX package does, puts its glass at 240 of 4,940 ids
    (4.86%: "shrink"); with the boxes it is 260 of 4,960 (5.24%)."""
    objs = [{"type": "sphere",
             "position": [(i % 50) * 1.1, (i // 50) * 1.1, -20.0],
             "radius": 0.4,
             "material": {"type": "lambertian", "color": [0.6, 0.6, 0.6]}}
            for i in range(4700)]
    objs += [{"type": "cube", "position": [i * 2.0, -3.0, -10.0],
              "size": [1.0, 1.0, 1.0],
              "material": {"type": "glass", "color": [0.9, 0.9, 0.9]}}
             for i in range(20)]
    return {"camera": {"position": [25, 25, 30], "aspectRatio": 1.333},
            "objects": objs,
            "lights": [{"type": "point", "position": [10, 30, 20],
                        "color": [1, 1, 1], "intensity": 2.0}]}


@pytest.fixture(scope="module")
def policy_scenes(tmp_path_factory):
    """(JAX scene, port scene) of grid-5833, ico-10241, mixed (a bvh
    scene) and the box-glass stream scene, built without their BVH: the
    policies read the materials and the kernel mode, which needs only
    that there is an accel."""
    tmp = str(tmp_path_factory.mktemp("obj"))
    dicts = {"grid5833": suite.grid_scene_dict(),
             "ico10241": suite.mesh_scene_dict(tmp),
             "mixed": suite.mixed_scene_dict(),
             "boxglass": box_glass_scene_dict()}
    return {n: (jscene.from_dict(d, build_accel=False)[0],
                tscene.from_dict(d, device="cpu", build_accel=False)[0])
            for n, d in dicts.items()}


def refractive_share(scene):
    """The corrected policy's input, from numpy: the glass or dielectric
    share of the material ids of every geometry table."""
    g = scene.geometry
    ids = np.concatenate([t.numpy().reshape(-1) for t in (
        g.sph_mat, g.tri_mat, g.pl_mat, g.box_mat)])
    kind = scene.materials.kind.numpy()[ids]
    return float(np.isin(kind, (4, 5)).mean())  # GLASS, DIELECTRIC


@pytest.mark.parametrize("name", ["grid5833", "ico10241", "mixed",
                                  "boxglass"])
def test_split_policies_match_jax(policy_scenes, name, monkeypatch):
    """pick_deep_caps counts planes and boxes too; on the scenes where
    they do not change the verdict both packages' policies and ladders
    are equal, and on the box-glass scene the port says "const" where the
    JAX package says "shrink" (its ladder then starts at bounce 4, as
    grid-5833's)."""
    for var in ("RT_SPLIT", "RT_NO_SPLIT", "RT_SURV_FRAC"):
        monkeypatch.delenv(var, raising=False)
    js, ts = policy_scenes[name]
    marker = object()
    js = dataclasses.replace(js, accel=marker)
    ts = dataclasses.replace(ts, accel=marker)
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(js)
    caps = trender.pick_deep_caps(ts)
    assert caps == ("const" if refractive_share(ts) >= 0.05 else "shrink")
    if name == "boxglass":
        assert (caps, jrender.pick_deep_caps(js)) == ("const", "shrink")
        ref = dataclasses.replace(policy_scenes["grid5833"][0],
                                  accel=marker)
    else:
        assert caps == jrender.pick_deep_caps(js)
        ref = js
    for depth in (5, 11, 12, 13, 20, 50, 100):
        jcfg = jtrace.TraceConfig(max_depth=depth)
        tcfg = ttrace.TraceConfig(max_depth=depth)
        assert trender.pick_split(ts, tcfg) == jrender.pick_split(ref, jcfg)
    want = {"grid5833": (4, 7, 10, 14, 20, 29, 42),
            "ico10241": (2, 5, 8, 11, 15, 21, 30, 43), "mixed": 0,
            "boxglass": (4, 7, 10, 14, 20, 29, 42)}[name]
    assert trender.pick_split(ts, ttrace.TraceConfig()) == want


@pytest.mark.parametrize("n", [1, 100, 2047, 2048, 2049, 8192, 40000,
                               4_194_304, 4_194_303])
def test_capacity_and_levels_match_jax(n, monkeypatch):
    monkeypatch.delenv("RT_SURV_FRAC", raising=False)
    for frac in (None, 2, 8):
        # the JAX stream kernel's block: 16 rows (pick_block_rows)
        want = jrender._auto_surv_cap(n, 16, frac=frac)
        assert trender._auto_surv_cap(n, frac=frac) == want
    for spec in (0, 5, (2, 4), (4, 7, 10)):
        assert trender._split_levels(spec) == jrender._split_levels(spec)
