"""The scene-config path of the port: atmosphere.py, effects.py and the
Renderer's effects stage, against the JAX package on the CPU.

* Every ported function of atmosphere.py and effects.py against its JAX
  counterpart on seeded inputs: rtol=1e-5, atol=1e-5 (both compute the
  same float32 expressions; exp, pow, sin and cos may round an ulp or two
  apart between XLA and PyTorch). Settings and presets are equal.
* The sky's hit mask and the primary depth's miss flags: exact (the
  any-hit and closest-hit tests are the ported ones, equal bit for bit).
* atmosphere_demo.json renders through ``python -m
  raytrace_tpu_torch.cli ... --device cpu`` at 32x24, 2 spp (its look-at
  camera: the reference camera sees only sky), and its linear image with
  the effects applied (render, sky, fog, volumetric) passes the goldens
  image gate (at most 0.1% of pixels off by more than 1e-3, mean abs
  error < 1e-4) against the JAX Renderer's render_linear and
  _apply_scene_effects, the two halves of its Renderer.render(...,
  scene_config) before the tone map.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import make_goldens
from raytrace_tpu import atmosphere as jatmo
from raytrace_tpu import effects as jfx
from raytrace_tpu import renderer as jrender
from raytrace_tpu import scene as jscene
from raytrace_tpu_torch import atmosphere as tatmo
from raytrace_tpu_torch import cli
from raytrace_tpu_torch import effects as tfx
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch.bench.suite import bvh_scene_dict
from raytrace_tpu_torch.utils import image as timage
from test_torch_scene import one_torch_thread  # noqa: F401

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(8)
IMG = RNG.uniform(0, 2.0, (24, 32, 3)).astype(np.float32)
DEPTH = RNG.uniform(0.5, 30.0, (24, 32)).astype(np.float32)
DIRS = RNG.normal(size=(500, 3)).astype(np.float32)
PTS = RNG.uniform(-2, 2, (300, 3)).astype(np.float32)
NRM = RNG.normal(size=(300, 3)).astype(np.float32)
COS = RNG.uniform(-1, 1, 400).astype(np.float32)
T = torch.from_numpy


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def golden_dict(name):
    return {n: d for n, d, _ in make_goldens.scenes()}[name]


def both(d):
    return jscene.from_dict(d)[0], tscene.from_dict(d, device="cpu")[0]


@pytest.mark.parametrize("preset", ["default", "white", "sunset", "night",
                                    "custom"])
def test_sky_color(preset):
    block = {"preset": preset}
    if preset == "custom":
        block = {"preset": "sunset", "sunDirection": [0.1, 0.9, 0.2],
                 "sunSize": 0.2, "fogAmount": 0.3, "fogColor": [0.5, 0.5, 1]}
    js, ts = (jatmo.settings_from_config(block),
              tatmo.settings_from_config(block))
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    # directions around the sun, so the disk shows
    d = DIRS.copy()
    d[:100] = np.asarray(ts.sun_direction, np.float32) + 0.05 * d[:100]
    close(tatmo.get_sky_color(T(d), ts), jatmo.get_sky_color(d, js))


def test_presets_and_phase_functions():
    assert ({k: dataclasses.asdict(v) for k, v in jatmo.presets().items()}
            == {k: dataclasses.asdict(v)
                for k, v in tatmo.presets().items()})
    dist = RNG.uniform(0, 50, 100).astype(np.float32)
    close(tatmo.atmospheric_attenuation(T(dist)),
          jatmo.atmospheric_attenuation(dist))
    close(tatmo.rayleigh_phase(T(COS)), jatmo.rayleigh_phase(COS))
    for g in (0.76, 0.9):
        close(tatmo.henyey_greenstein_phase(T(COS), g),
              jatmo.henyey_greenstein_phase(COS, g))
    close(tatmo.height_density(T(dist * 100)),
          jatmo.height_density(dist * 100))


@pytest.mark.parametrize("name", ["spheres_metal_glass", "mixed-noground"])
def test_sky_hit_mask_and_primary_depth(name):
    d = bvh_scene_dict(name) if name.startswith("mixed") else golden_dict(name)
    js, ts = both(d)
    W, H = 32, 24
    st = tatmo.settings_from_config({"preset": "sunset"})
    sj = jatmo.settings_from_config({"preset": "sunset"})
    got = tatmo.apply_sky_to_image(ts, T(IMG), W, H, st).numpy()
    want = np.asarray(jatmo.apply_sky_to_image(js, jnp.asarray(IMG), W, H,
                                               sj))
    hit_t = (got == IMG).all(-1)
    hit_j = (want == IMG).all(-1)
    assert hit_t.any() and (~hit_t).any()
    np.testing.assert_array_equal(hit_t, hit_j)
    close(got, want)
    # the primary depth: miss flags exact, distances within TOL
    rt, rj = trender.Renderer(device="cpu"), jrender.Renderer()
    dt = rt._primary_depth(ts, W, H).numpy()
    dj = np.asarray(rj._primary_depth(js, W, H))
    big = np.float32(3.0e38)
    np.testing.assert_array_equal(dt >= big, dj >= big)
    assert (dt < big).any() and (dt >= big).any()
    close(np.where(dt < big, dt, 0), np.where(dj < big, dj, 0))


@pytest.mark.parametrize("mode", ["exp", "exp2", "linear"])
def test_fog(mode):
    kw = dict(mode=mode, density=0.05, start=2.0, end=25.0)
    close(tfx.fog_factor(T(DEPTH), **kw), jfx.fog_factor(DEPTH, **kw))
    close(tfx.apply_fog(T(IMG), T(DEPTH), fog_color=(0.2, 0.3, 0.4), **kw),
          jfx.apply_fog(IMG, DEPTH, fog_color=(0.2, 0.3, 0.4), **kw))
    with pytest.raises(ValueError):
        tfx.fog_factor(T(DEPTH), mode="fancy")


def test_volumetric_light():
    d = golden_dict("spheres_metal_glass")
    js, ts = both(d)
    o = np.broadcast_to(np.float32([0, 0.5, 8]), (300, 3)).copy()
    md = RNG.uniform(5, 20, 300).astype(np.float32)
    kw = dict(steps=16, density=0.03, scattering=0.4)
    close(tfx.volumetric_light(T(o), T(NRM), T(md), ts.lights, **kw),
          jfx.volumetric_light(o, NRM, md, js.lights, **kw))


@pytest.mark.parametrize("fn", ["blur", "bloom", "vignette", "chromatic",
                                "motion_blur", "dof_blur", "lens_flare"])
def test_image_passes(fn):
    img = IMG.copy()
    img[5:9, 10:14] = 4.0   # bright enough to bloom
    cases = {
        "blur": (lambda m, x: m._blur(x, 1.5), ()),
        "bloom": (lambda m, x: m.bloom(x, threshold=1.0, intensity=0.4), ()),
        "vignette": (lambda m, x: m.vignette(x, strength=0.6, radius=0.5),
                     ()),
        "chromatic": (lambda m, x: m.chromatic_aberration(x, 2.0), ()),
        "motion_blur": (lambda m, x: m.motion_blur([x, x * 0.5, x + 1.0]),
                        ()),
        "dof_blur": (lambda m, x, dep: m.depth_of_field_blur(
            x, dep, focal_distance=6.0, aperture=0.2), (DEPTH,)),
        "lens_flare": (lambda m, x: m.lens_flare(x, (0.7, 0.3), 0.5), ()),
    }
    f, extra = cases[fn]
    got = f(tfx, T(img), *(T(e) for e in extra))
    want = f(jfx, jnp.asarray(img), *(jnp.asarray(e) for e in extra))
    close(got, want)


def test_hit_helpers():
    d = golden_dict("spheres_metal_glass")
    js, ts = both(d)
    close(tfx.caustic_approximation(T(PTS), T(NRM), ts.lights),
          jfx.caustic_approximation(PTS, NRM, js.lights))
    close(tfx.bump_map_normal(T(PTS), T(NRM), 0.2),
          jfx.bump_map_normal(PTS, NRM, 0.2))
    close(tfx.procedural_texture_color(T(PTS)),
          jfx.procedural_texture_color(PTS))


def test_config_effects():
    blocks = {"bloom": {"enabled": True, "threshold": 1.2},
              "depthOfField": {"enabled": True, "focalDistance": 8.0},
              "lensFlare": {"enabled": True, "intensity": 0.2},
              "chromaticAberration": {"enabled": True, "strength": 1.0},
              "vignette": {"enabled": True, "strength": 0.3}}
    close(tfx.apply_config_effects(T(IMG), blocks, depth=T(DEPTH)),
          jfx.apply_config_effects(jnp.asarray(IMG), blocks,
                                   depth=jnp.asarray(DEPTH)))
    # a disabled block changes nothing
    same = tfx.apply_config_effects(T(IMG), {"bloom": {"enabled": False}})
    assert torch.equal(same, T(IMG))


def test_atmosphere_demo_renders_through_cli(tmp_path, capsys):
    W, H, S = 32, 24, 2
    path = os.path.join(ASSETS, "atmosphere_demo.json")
    out = str(tmp_path / "atmo.png")
    assert cli.main([path, out, str(W), str(H), "--samples", str(S),
                     "--lookat-camera", "--device", "cpu",
                     "--ascii-preview"]) == 0
    img = timage.read_png(out)
    assert img.shape == (H, W, 3)
    assert len(capsys.readouterr().out.splitlines()) >= H // 2
    # the linear image with the effects, against the JAX Renderer's
    js, jcfg = jscene.load(path)
    ts, tcfg = tscene.load(path, device="cpu")
    rj, rt = jrender.Renderer(), trender.Renderer(device="cpu")
    for r in (rj, rt):
        r.set_samples(S)
        r.go_camera = False
    lin_t = rt.render_linear_device(ts, W, H)
    lin_j = rj.render_linear(js, W, H)
    assert (np.asarray(lin_j).sum(-1) > 0).mean() > 0.05
    got = rt._apply_scene_effects(ts, lin_t, W, H, tcfg).numpy()
    want = np.asarray(rj._apply_scene_effects(js, lin_j, W, H, jcfg))
    diff = np.abs(got - want).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.001
    assert float(np.abs(got - want).mean()) < 1e-4
    # the CLI's PNG is the tone map of the same image
    from raytrace_tpu_torch.ops import tonemap
    u8 = tonemap.tonemap_rgb8(torch.from_numpy(got)).numpy()
    assert (np.abs(u8.astype(int) - img.astype(int)) > 1).mean() <= 0.001


def test_write_ppm(tmp_path):
    img = (IMG[:4, :5] * 100).astype(np.uint8)
    p = str(tmp_path / "a.ppm")
    timage.write_ppm(p, img)
    lines = open(p).read().split("\n")
    assert lines[:3] == ["P3", "5 4", "255"]
    vals = np.array(" ".join(lines[3:]).split(), int).reshape(4, 5, 3)
    np.testing.assert_array_equal(vals, img)
    p2 = str(tmp_path / "b.ppm")
    timage.write_ppm_float(p2, IMG[:4, :5] / 2.0, gamma=2.2)
    from raytrace_tpu.utils import image as jimage
    p3 = str(tmp_path / "c.ppm")
    jimage.write_ppm_float(p3, IMG[:4, :5] / 2.0, gamma=2.2)
    assert open(p2).read() == open(p3).read()
