"""The port's AOV buffers, denoiser and accumulator checkpoints on the CPU.

* render_aovs against raytrace_tpu.aov.render_aovs (run under
  jax.disable_jit(), as the bvh tests run the JAX walks: compiled XLA
  rounds differently) on scenes carried across with
  convert.scene_from_numpy (unroll mode, boxes and a plane, the look-at
  camera, and the bvh golden with its tree): hit, mat_id and front_face
  equal, the float buffers within an absolute 1e-5, the miss sentinels
  (depth BIG, mat_id -1, zeros) in place.
* denoise against raytrace_tpu.denoising.denoise on a seeded noisy image
  over the JAX package's feature buffers, dense (radius 3) and a-trous
  (3 passes), with and without a variance map: within an absolute 1e-5;
  miss pixels pass through; the frame edges do not wrap.
* parallel/checkpoint: the Accumulator's npz round trip, read by the
  JAX package's Accumulator and back; render_with_checkpoints resumed
  equals the uninterrupted render; the shutdown helpers.
* Renderer.render(denoise=True) and the default device.
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch

import make_goldens
from raytrace_tpu import aov as jaov
from raytrace_tpu import denoising as jdenoise
from raytrace_tpu import scene as jscene
from raytrace_tpu.parallel import checkpoint as jckpt
from raytrace_tpu_torch import aov as taov
from raytrace_tpu_torch import denoising as tdenoise
from raytrace_tpu_torch import parallel as tparallel
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch.ops import intersect
from test_torch_adaptive import carry, golden_dict
from test_torch_scene import one_torch_thread  # noqa: F401

W, H = 16, 12
BITS = ("hit", "mat_id", "front_face")
FLOATS = ("depth", "position", "normal", "albedo")
# The look-at camera's rays differ from the JAX package's by an ulp (tan,
# the basis normalisation: tests/test_torch_renderer.py), which a grazing
# hit on a radius-100 ground sphere amplifies past 1e-5 in depth; its case
# runs on the scene of boxes over a plane.
AOV_CASES = [("spheres_metal_glass", True), ("cubes_dielectric_plane", True),
             ("cubes_dielectric_plane", False), ("prism_perfectmirror", True),
             ("bvh_golden", True)]


def jax_scene(name):
    if name == "bvh_golden":
        return jscene.from_dict(make_goldens.bvh_scene()[0])[0]
    return jscene.from_dict(golden_dict(name))[0]


@pytest.mark.parametrize("name,go_camera", AOV_CASES,
                         ids=[f"{n}-{'go' if g else 'lookat'}"
                              for n, g in AOV_CASES])
def test_aovs_match_jax(name, go_camera):
    js = jax_scene(name)
    ts = carry(js)
    with jax.disable_jit():  # compiled XLA contracts multiply-adds
        want = jaov.render_aovs(js, width=W, height=H, go_camera=go_camera)
    got = taov.render_aovs(ts, width=W, height=H, go_camera=go_camera,
                           device="cpu")
    assert got.keys() == want.keys()
    for k in BITS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in FLOATS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    hit = got["hit"]
    assert hit.any() and (~hit).any()
    assert (got["depth"][~hit] == intersect.BIG).all()
    assert (got["mat_id"][~hit] == -1).all()
    for k in ("position", "normal", "albedo"):
        assert (got[k][~hit] == 0.0).all()


def noisy_inputs(name="spheres_metal_glass", go_camera=True):
    """A seeded noisy radiance image and variance map over the JAX
    package's feature buffers of a golden scene."""
    js = jax_scene(name)
    aovs = jaov.render_aovs(js, width=W, height=H, go_camera=go_camera)
    rs = np.random.default_rng(0)
    base = np.where(aovs["hit"][..., None], aovs["albedo"], 0.05)
    img = (base + rs.normal(0.0, 0.05, (H, W, 3))).astype(np.float32)
    var = rs.uniform(1e-4, 4e-3, (H, W)).astype(np.float32)
    return img, aovs, var


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("use_var", [False, True], ids=["plain", "variance"])
def test_denoise_matches_jax(passes, use_var):
    img, aovs, var = noisy_inputs()
    v = var if use_var else None
    want = jdenoise.denoise(img, aovs, variance=v, passes=passes)
    got = tdenoise.denoise(img, aovs, variance=v, passes=passes,
                           device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    miss = ~aovs["hit"]
    assert miss.any()
    np.testing.assert_array_equal(got[miss], img[miss])
    assert np.abs(got - img)[~miss].max() > 1e-3  # the filter acted


def test_denoise_takes_tensors_and_the_bvh_scene():
    img, aovs, var = noisy_inputs("bvh_golden")
    want = jdenoise.denoise(img, aovs, variance=var, radius=2)
    t_aovs = {k: torch.from_numpy(np.array(v)) for k, v in aovs.items()}
    got = tdenoise.denoise(torch.from_numpy(img), t_aovs,
                           variance=torch.from_numpy(var), radius=2,
                           device="cpu")
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_denoise_does_not_wrap_the_frame():
    """torch.roll wraps: the inside-frame mask must keep the left edge
    from blending with the right one (identical features, far values)."""
    hh, ww = 24, 32
    left = np.arange(ww)[None, :] < ww // 2
    clean = np.broadcast_to(np.where(left[..., None], 0.2, 0.8),
                            (hh, ww, 3)).astype(np.float32)
    noisy = clean + np.random.default_rng(0).normal(
        0, 0.05, clean.shape).astype(np.float32)
    aovs = {"depth": np.full((hh, ww), 5.0, np.float32),
            "normal": np.broadcast_to(np.float32([0, 0, 1]),
                                      (hh, ww, 3)).copy(),
            "albedo": np.full((hh, ww, 3), 0.5, np.float32),
            "hit": np.ones((hh, ww), bool)}
    out = tdenoise.denoise(noisy, aovs, radius=3, device="cpu")
    np.testing.assert_allclose(out, jdenoise.denoise(noisy, aovs, radius=3),
                               rtol=0, atol=1e-5)
    assert abs(out[:, 0].mean() - 0.2) < 0.1
    assert abs(out[:, -1].mean() - 0.8) < 0.1


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default is usable")
    ts = carry(jax_scene("spheres_metal_glass"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        taov.render_aovs(ts, width=W, height=H)
    img, aovs, _ = noisy_inputs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdenoise.denoise(img, aovs)


def test_renderer_render_denoise():
    ts = carry(jax_scene("spheres_metal_glass"))
    r = trender.Renderer(device="cpu")
    r.set_samples(2)
    r.set_max_depth(3)
    plain = r.render(ts, W, H)
    den = r.render(ts, W, H, denoise=True)
    assert den.dtype == np.uint8 and den.shape == (H, W, 3)
    assert not np.array_equal(den, plain)
    lin = r.render_linear_device(ts, W, H)
    aovs = taov.render_aovs(ts, width=W, height=H, as_numpy=False,
                            device="cpu")
    want = tdenoise.denoise(lin, aovs, device="cpu")
    from raytrace_tpu_torch.ops import tonemap
    np.testing.assert_array_equal(den, tonemap.tonemap_rgb8(want).numpy())


def test_accumulator_roundtrip_across_packages(tmp_path):
    acc = tparallel.Accumulator.zeros(8, 4, seed=7)
    rs = np.random.default_rng(0)
    band = rs.uniform(0, 1, (4, 8, 3)).astype(np.float32)
    acc.add(band, 10)
    p = str(tmp_path / "ck.npz")
    acc.save(p)
    back = tparallel.Accumulator.load(p)
    assert (back.samples_done, back.seed, back.width, back.height) == (
        10, 7, 8, 4)
    np.testing.assert_array_equal(back.radiance_sum, acc.radiance_sum)
    np.testing.assert_allclose(back.mean(), band, rtol=1e-6)
    j = jckpt.Accumulator.load(p)
    np.testing.assert_array_equal(j.radiance_sum, acc.radiance_sum)
    j.add(band, 2)
    j.save(p)
    again = tparallel.Accumulator.load(p)
    assert again.samples_done == 12
    np.testing.assert_array_equal(again.radiance_sum, j.radiance_sum)


def test_render_with_checkpoints_resumes(tmp_path):
    ts = carry(jax_scene("spheres_metal_glass"))

    def fresh():
        r = trender.Renderer(device="cpu")
        r.set_max_depth(3)
        return r

    ckpt = str(tmp_path / "render.npz")
    full = tparallel.render_with_checkpoints(
        fresh(), ts, W, H, total_samples=4, samples_per_round=2)
    tparallel.render_with_checkpoints(
        fresh(), ts, W, H, total_samples=2, samples_per_round=2,
        checkpoint_path=ckpt)
    assert tparallel.Accumulator.load(ckpt).samples_done == 2
    r = fresh()
    resumed = tparallel.render_with_checkpoints(
        r, ts, W, H, total_samples=4, samples_per_round=2,
        checkpoint_path=ckpt)
    np.testing.assert_array_equal(resumed, full)
    assert (r.samples, r.seed) == (100, 0)  # settings restored
    assert resumed.dtype == np.float32 and (resumed > 0).any()


def test_shutdown_helpers():
    ran = []
    rm = tparallel.ResourceManager()
    rm.register("a", lambda: ran.append("a"))
    rm.register("b", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    rm.register("c", lambda: ran.append("c"))
    errs = rm.close_all()
    assert ran == ["c", "a"] and [e[0] for e in errs] == ["b"]
    cs = tparallel.ContextShutdown(timeout=0.2)
    cs.register("ok", lambda: None)
    cs.register("err", lambda: (_ for _ in ()).throw(ValueError("x")))
    assert [e[0] for e in cs.shutdown()] == ["err"]
    hits = []
    sh = tparallel.SignalHandler()
    sh.register(signal.SIGUSR1, lambda: hits.append(1))
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
    finally:
        sh.uninstall()
    assert hits == [1]
    order = []
    gs = tparallel.GracefulShutdown()
    gs.register("first", lambda: order.append("first"))
    gs.register("second", lambda: order.append("second"))
    gs.install()
    try:
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
    finally:
        gs.uninstall()
    assert order == ["second", "first"]
