"""The port's main path end to end on the CPU.

* render_wavefront (mask -> compaction -> trace -> segment-add) equals the
  dense render_band under the goldens gate (tests/test_goldens.py:35-39):
  the RNG is keyed by (pixel, sample), so both trace the same lanes and
  only the order of the per-pixel sums may differ.
* look-at camera rays against raytrace_tpu.camera within 1e-6 (tan and
  the basis normalisation may round an ulp differently).
* tonemap_rgb8 against raytrace_tpu.ops.tonemap: at most one 8-bit step
  apart (exp and pow are library functions that may round an ulp
  differently near a quantisation edge).
* The CLI writes a PNG that reads back at the right size, and entry points
  without a device raise where there is no GPU.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu import camera as jcam
from raytrace_tpu import renderer as jrender
from raytrace_tpu import scene as jscene
from raytrace_tpu.ops import tonemap as jtonemap
from raytrace_tpu_torch import camera as tcam
from raytrace_tpu_torch import cli
from raytrace_tpu_torch import effects as tfx
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.ops import tonemap as ttonemap
from raytrace_tpu_torch.utils import image as timage
from test_torch_scene import one_torch_thread  # noqa: F401

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")


def asset_dict(name):
    with open(os.path.join(ASSETS, f"{name}.json")) as f:
        d = json.load(f)
    d["camera"]["position"][2] = -d["camera"]["position"][2]
    return d


def gate(img, ref):
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.001
    assert float(np.abs(img - ref).mean()) < 1e-4


@pytest.mark.parametrize("name,go_camera", [
    ("sphere_reflections_light", True), ("two_red_cubes_scene", True),
    ("final_silver_prism_purple_cube", True),
    ("two_red_cubes_scene", False)])
def test_wavefront_equals_dense(name, go_camera):
    ts = tscene.from_dict(asset_dict(name), device="cpu")[0]
    cfg = ttrace.TraceConfig(max_depth=8, shadow_samples=4)
    kw = dict(width=40, height=30, samples=3, cfg=cfg, go_camera=go_camera)
    wf = trender.render_wavefront(ts, **kw).numpy()
    dense = trender.render_band(ts, 0, band_h=30, **kw).numpy()
    assert (dense.sum(-1) > 0).any()
    gate(wf, dense)


def test_renderer_engines_agree():
    ts = tscene.from_dict(asset_dict("sphere_reflections_light"),
                          device="cpu")[0]
    r = trender.Renderer(device="cpu")
    r.set_samples(2)
    r.set_max_depth(6)
    wf = r.render_linear(ts, 48, 36)
    gate(wf, trender.render_band(ts, 0, width=48, height=36, band_h=36,
                                 samples=2, cfg=r.trace_config()).numpy())
    img = r.render(ts, 48, 36)
    assert img.shape == (36, 48, 3) and img.dtype == np.uint8
    assert r.benchmark_data.objects == 5 and r.benchmark_data.lights == 2
    assert json.loads(r.benchmark_data.to_json()).keys() == json.loads(
        jrender.BenchmarkData().to_json()).keys()


def test_lookat_rays_match_jax():
    """Look-at camera rays within 1e-6: tan and the basis normalisation
    round an ulp differently between XLA and PyTorch."""
    d = asset_dict("two_red_cubes_scene")
    js, _ = jscene.from_dict(d)
    ts, _ = tscene.from_dict(d, device="cpu")
    r = np.random.default_rng(3)
    u, v = (r.random(512).astype(np.float32) for _ in range(2))
    jo, jd = jcam.lookat_rays(js.camera, jnp.asarray(u), jnp.asarray(v))
    to, td = tcam.lookat_rays(ts.camera, torch.from_numpy(u),
                              torch.from_numpy(v))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-6)


def test_tonemap_matches_jax():
    lin = np.random.default_rng(0).gamma(0.6, 0.5, (64, 64, 3)).astype(
        np.float32)
    ref = np.asarray(jtonemap.tonemap_rgb8(jnp.asarray(lin))).astype(int)
    got = ttonemap.tonemap_rgb8(torch.from_numpy(lin)).numpy().astype(int)
    assert np.abs(got - ref).max() <= 1
    assert (got == ref).mean() > 0.999


def test_cli_writes_png(tmp_path):
    out = tmp_path / "out.png"
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(asset_dict("two_red_cubes_scene")))
    rc = cli.main([str(scene), str(out), "24", "18", "--samples", "2",
                   "--max-depth", "4", "--device", "cpu"])
    assert rc == 0
    img = timage.read_png(str(out))
    assert img.shape == (18, 24, 3)
    assert (img.sum(-1) > 0).mean() > 0.2
    assert (tmp_path / "benchmark_data.json").exists()


def test_scene_config_renderer_block_and_effects():
    d = asset_dict("final_silver_prism_purple_cube")
    ts, cfg = tscene.from_dict(d, device="cpu")
    r = trender.Renderer(device="cpu")
    cfg.renderer = {"samples": 1, "maxDepth": 2, "softShadows": False}
    img = r.render(ts, 16, 12, scene_config=cfg)
    assert img.shape == (12, 16, 3)
    assert (r.samples, r.max_depth, r.soft_shadows) == (1, 2, False)
    # the effects run on the linear image before the tone map
    cfg.fog = {"enabled": True}
    img = r.render(ts, 16, 12, scene_config=cfg)
    lin = r.render_linear_device(ts, 16, 12)
    depth = r._primary_depth(ts, 16, 12)
    want = ttonemap.tonemap_rgb8(tfx.apply_fog(lin, depth.clamp(max=1e4)))
    assert np.array_equal(img, want.numpy())
    assert not np.array_equal(img, ttonemap.tonemap_rgb8(lin).numpy())


def test_no_device_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trender.Renderer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([os.path.join(ASSETS, "two_red_cubes_scene.json"),
                  "unused.png", "8", "6"])


def test_fast_mc_and_dof_renderer_settings_render():
    """The Renderer's fast_mc and depth-of-field settings render through
    the main path, with the trace settings of the JAX Renderer."""
    ts = tscene.from_dict(asset_dict("two_red_cubes_scene"),
                          device="cpu")[0]
    r = trender.Renderer(device="cpu")
    r.set_samples(1)
    r.fast_mc = True
    cfg = r.trace_config()
    assert (cfg.russian_roulette_start, cfg.throughput_epsilon) == (8, 1e-4)
    img = r.render(ts, 8, 6)
    assert img.shape == (6, 8, 3) and img.dtype == np.uint8
    r.fast_mc = False
    r.set_depth_of_field(True)
    cfg = r.trace_config()
    assert cfg.depth_of_field
    lin = r.render_linear(ts, 8, 6)
    want = trender.render_wavefront(ts, width=8, height=6, samples=1,
                                    cfg=cfg).numpy()
    assert np.array_equal(lin, want) and np.isfinite(lin).all()


def test_past_cap_render_matches_jax_banded_engine(monkeypatch):
    """Past the JAX package's stream cap (MAX_STREAM_KERNEL_PRIMS, lowered
    here below a small scene forced into stream mode) the port's Renderer
    stays on the stream route - K6-stream's and K5's plain versions on the
    CPU, as the split ladder at depth 12 - where the JAX Renderer renders
    with its banded jnp engine (raytrace_tpu/renderer.py:917-972): the two
    images agree under the goldens gate."""
    from raytrace_tpu_torch.bench.suite import ring_scene_dict
    from raytrace_tpu_torch.ops import megakernel as tmk
    d = ring_scene_dict(12)
    js = jscene.from_dict(d)[0]
    monkeypatch.setattr(tmk, "UNROLL_PRIM_LIMIT", 4)
    monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 8)
    monkeypatch.setattr(tmk, "MAX_STREAM_KERNEL_PRIMS", 8)
    ts = tscene.with_accel(tscene.from_dict(d, device="cpu",
                                            build_accel=False)[0],
                           leaf_size=4)
    assert ts.prim_count > tmk.MAX_STREAM_KERNEL_PRIMS
    assert not tmk.scene_fits_kernel(ts)
    assert tmk.require_mode(ts) == "stream"
    assert ts.accel.stream_tab is not None
    jr, tr = jrender.Renderer(), trender.Renderer(device="cpu")
    for r in (jr, tr):
        r.set_samples(2)
        r.set_max_depth(12)
    assert trender.pick_split(ts, tr.trace_config())
    want = jr.render_linear(js, 8, 6)
    got = tr.render_linear(ts, 8, 6)
    assert got.shape == want.shape == (6, 8, 3)
    assert (want.sum(-1) > 0).any()
    gate(got, want)


def test_namespace_exports_the_ports_names():
    """The package exports Scene, render_band and trace_rays beside its
    other entry points, as raytrace_tpu/__init__.py does, and each is the
    port's own object."""
    import raytrace_tpu
    import raytrace_tpu_torch as rtt
    from raytrace_tpu_torch import scene as scene_mod
    for name in ("Scene", "render_band", "trace_rays", "Renderer",
                 "TraceConfig", "load_scene", "scene_from_dict"):
        assert name in rtt.__all__ and name in raytrace_tpu.__all__
        obj = getattr(rtt, name)
        assert obj.__module__.startswith("raytrace_tpu_torch."), name
        assert obj is not getattr(raytrace_tpu, name)
    assert rtt.Scene is scene_mod.Scene
    assert rtt.render_band is trender.render_band
    assert rtt.trace_rays is ttrace.trace
