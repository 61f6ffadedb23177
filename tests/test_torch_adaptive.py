"""The port's adaptive sampling (raytrace_tpu_torch/adaptive.py) on the CPU.

Against the JAX package (engine="jnp", no Pallas interpret call), on
three scenes carried across with convert.scene_from_numpy: the
spheres_metal_glass golden (unroll mode), the bvh golden of
tests/make_goldens.py (109 spheres, bvh mode) and spheres_metal_glass
forced into stream mode (MAX_BVH_KERNEL_PRIMS and UNROLL_PRIM_LIMIT
lowered in both packages, a leaf-4 tree; glassy, so at depth 12 the
port's batches trace through the full-capacity split ladder), each in
host and in device accumulation:

* the image under the goldens gate (tests/test_goldens.py:35-39);
* spp maps equal on at least 99.9% of the JAX-active pixels (the f32
  device sums and luma may decide a pixel near the threshold
  differently);
* the port's first active set is the cone mask, a superset of the JAX
  package's CPU mask (every jittered ray tested): its extra pixels are
  black and stop at the first test round; every pixel outside both is
  black with spp 0.

Within the port: rel_tol = abs_tol = 0 equals render_wavefront at the
same spp (rtol 1e-6) in both modes; batch 2 against batch 8 is invisible;
an interrupted and resumed render is bit-identical to the uninterrupted
one in both modes; a checkpoint with another split spec, without one, of
another scene, batch or accumulation mode is refused; the Renderer
wrapper and the CLI run with --adaptive --denoise. Over a mesh of 8 CPU
coordinates (``parallel.make_mesh``), both modes hold the gates above
against the JAX package's 8-device mesh and equal the unsharded run bit
for bit.
"""

import os

import numpy as np
import pytest
import torch

import make_goldens
from raytrace_tpu import adaptive as jadaptive
from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu.ops import megakernel as jmk
from raytrace_tpu_torch import adaptive as tadaptive
from raytrace_tpu_torch import cli
from raytrace_tpu_torch import convert
from raytrace_tpu_torch import parallel as tparallel
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.ops import megakernel as tmk
from test_torch_scene import TREE, jax_leaves, one_torch_thread  # noqa: F401

W, H = 16, 12
KW = dict(width=W, height=H, min_spp=4, max_spp=16, batch=4, rel_tol=0.05,
          abs_tol=1e-3)
SCENES = ("spheres_metal_glass", "bvh_golden", "stream_forced")
DEPTH = {"spheres_metal_glass": 4, "bvh_golden": 4, "stream_forced": 12}


def gate(img, ref):
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.001
    assert float(np.abs(img - ref).mean()) < 1e-4


def golden_dict(name):
    return {n: d for n, d, _ in make_goldens.scenes()}[name]


def carry(js):
    """The JAX scene's tables as the port's Scene (convert)."""
    return convert.scene_from_numpy(
        **jax_leaves(js), occl_tris=js.geometry.occl_tris,
        sph_count=js.sph_count, mesh_count=js.mesh_count,
        accel=None if js.accel is None else {
            **{k: np.asarray(getattr(js.accel, k)) for k in TREE},
            "leaf_size": js.accel.leaf_size}, device="cpu")


def scenes(name, mp):
    """(JAX scene, port scene) by name; stream_forced lowers the mode
    limits of both packages (through ``mp``, a monkeypatch)."""
    if name == "bvh_golden":
        js = jscene.from_dict(make_goldens.bvh_scene()[0])[0]
    else:
        js = jscene.from_dict(golden_dict("spheres_metal_glass"))[0]
    if name == "stream_forced":
        for mk in (jmk, tmk):
            mp.setattr(mk, "UNROLL_PRIM_LIMIT", 4)
            mp.setattr(mk, "MAX_BVH_KERNEL_PRIMS", 4)
        js = jscene.with_accel(js, leaf_size=4)
    ts = carry(js)
    want = {"spheres_metal_glass": "unroll", "bvh_golden": "bvh",
            "stream_forced": "stream"}[name]
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(js) == want
    return js, ts


def configs(name):
    kw = dict(seed=0, max_depth=DEPTH[name], shadow_samples=2)
    return jtrace.TraceConfig(**kw), ttrace.TraceConfig(**kw)


def unroll_scene():
    return carry(jscene.from_dict(golden_dict("spheres_metal_glass"))[0])


@pytest.mark.parametrize("accum", ["host", "device"])
@pytest.mark.parametrize("name", SCENES)
def test_adaptive_matches_jax(name, accum, monkeypatch):
    js, ts = scenes(name, monkeypatch)
    jcfg, tcfg = configs(name)
    if name == "stream_forced":
        # the port's batches run the full-capacity ladder here
        assert tadaptive._split_spec(ts, tcfg)
    img_j, spp_j = jadaptive.render_adaptive(
        js, cfg=jcfg, engine="jnp", accum=accum, pad_quantum=256, **KW)
    img_t, spp_t = tadaptive.render_adaptive(ts, cfg=tcfg, accum=accum,
                                             device="cpu", **KW)
    assert img_t.dtype == np.float32 and spp_t.dtype == np.int32
    act = spp_j > 0
    assert act.any() and (~act).any()
    assert (spp_t[act] == spp_j[act]).mean() >= 0.999
    extra = ~act & (spp_t > 0)
    assert (spp_t[extra] == KW["min_spp"]).all()
    assert (img_t[~act] == 0.0).all() and (img_j[~act] == 0.0).all()
    assert (spp_t > KW["min_spp"]).any() and spp_t.max() <= KW["max_spp"]
    gate(img_t, img_j)


@pytest.mark.parametrize("accum", ["host", "device"])
def test_tol_zero_equals_wavefront(accum):
    ts = unroll_scene()
    cfg = ttrace.TraceConfig(seed=0, max_depth=4, shadow_samples=2)
    img, spp, var = tadaptive.render_adaptive(
        ts, width=W, height=H, cfg=cfg, min_spp=8, max_spp=8, batch=4,
        rel_tol=0.0, abs_tol=0.0, accum=accum, return_variance=True,
        device="cpu")
    ref = trender.render_wavefront(ts, width=W, height=H, samples=8,
                                   cfg=cfg).numpy()
    hit = spp > 0
    assert hit.any() and (spp[hit] == 8).all()
    assert (img[~hit] == 0.0).all()
    np.testing.assert_allclose(img, ref, rtol=1e-6, atol=0)
    assert var.shape == (H, W) and np.isfinite(var).all()
    assert (var >= 0).all()


def test_batching_is_invisible():
    ts = unroll_scene()
    cfg = ttrace.TraceConfig(seed=0, max_depth=3, shadow_samples=1)
    kw = dict(width=W, height=H, cfg=cfg, min_spp=8, max_spp=8,
              rel_tol=0.0, abs_tol=0.0, device="cpu")
    img2, spp2 = tadaptive.render_adaptive(ts, batch=2, **kw)
    img8, spp8 = tadaptive.render_adaptive(ts, batch=8, **kw)
    np.testing.assert_array_equal(spp2, spp8)
    np.testing.assert_allclose(img2, img8, atol=1e-6, rtol=1e-6)


class Interrupted(Exception):
    pass


def interrupt_after(monkeypatch, n):
    """Make adaptive._save_ckpt raise once it has written n checkpoints."""
    real = tadaptive._save_ckpt
    calls = {"n": 0}

    def dying(*a, **k):
        real(*a, **k)
        calls["n"] += 1
        if calls["n"] >= n:
            raise Interrupted

    monkeypatch.setattr(tadaptive, "_save_ckpt", dying)
    return real


@pytest.mark.parametrize("accum", ["host", "device"])
def test_resume_is_bit_exact(accum, tmp_path, monkeypatch):
    ts = unroll_scene()
    cfg = ttrace.TraceConfig(seed=0, max_depth=3, shadow_samples=2)
    kw = dict(KW, cfg=cfg, accum=accum, device="cpu")
    ref_img, ref_spp = tadaptive.render_adaptive(ts, **kw)
    ckpt = str(tmp_path / "adaptive.ckpt.npz")
    real = interrupt_after(monkeypatch, 2)
    with pytest.raises(Interrupted):
        tadaptive.render_adaptive(ts, checkpoint_path=ckpt, **kw)
    monkeypatch.setattr(tadaptive, "_save_ckpt", real)
    with np.load(ckpt) as z:
        assert int(z["s0"]) == 2 * KW["batch"]
        assert str(z["split"]) == "0" and str(z["accum"]) == accum
    img, spp = tadaptive.render_adaptive(ts, checkpoint_path=ckpt, **kw)
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(spp, ref_spp)
    # the finished state resumes and returns at once
    img2, _ = tadaptive.render_adaptive(ts, checkpoint_path=ckpt, **kw)
    np.testing.assert_array_equal(img2, ref_img)


def test_checkpoint_refuses_a_changed_run(tmp_path, monkeypatch):
    """A checkpoint pins the split spec (a departure from the JAX package,
    whose checkpoints lack it), the scene, the batch and the accumulation
    mode; one without the split spec is refused too."""
    ts = unroll_scene()
    cfg = ttrace.TraceConfig(seed=0, max_depth=3, shadow_samples=2)
    kw = dict(KW, cfg=cfg, accum="host", device="cpu")
    ckpt = str(tmp_path / "a.ckpt.npz")
    tadaptive.render_adaptive(ts, checkpoint_path=ckpt, **kw)
    with monkeypatch.context() as m:
        m.setattr(tadaptive, "_split_spec", lambda scene, cfg: (4, 7))
        with pytest.raises(ValueError, match="split"):
            tadaptive.render_adaptive(ts, checkpoint_path=ckpt, **kw)
    with pytest.raises(ValueError, match="batch"):
        tadaptive.render_adaptive(ts, checkpoint_path=ckpt,
                                  **dict(kw, batch=2))
    with pytest.raises(ValueError, match="accum"):
        tadaptive.render_adaptive(ts, checkpoint_path=ckpt,
                                  **dict(kw, accum="device"))
    other = carry(jscene.from_dict(golden_dict("prism_perfectmirror"))[0])
    with pytest.raises(ValueError, match="scene_sha"):
        tadaptive.render_adaptive(other, checkpoint_path=ckpt, **kw)
    with np.load(ckpt) as z:
        kept = {k: z[k] for k in z.files if k != "split"}
    np.savez(ckpt, **kept)
    with pytest.raises(ValueError, match="lacks 'split'"):
        tadaptive.render_adaptive(ts, checkpoint_path=ckpt, **kw)


def test_scene_fingerprint_ignores_the_device_and_sees_the_tables():
    ts = unroll_scene()
    fp = tadaptive._scene_fingerprint(ts)
    assert fp == tadaptive._scene_fingerprint(carry(jscene.from_dict(
        golden_dict("spheres_metal_glass"))[0]))
    lights = ts.lights.intensity.clone()
    lights[0] += 1.0
    moved = tscene.Scene(camera=ts.camera, geometry=ts.geometry,
                         materials=ts.materials,
                         lights=tscene.Lights(ts.lights.position,
                                              ts.lights.color, lights),
                         sph_count=ts.sph_count)
    assert tadaptive._scene_fingerprint(moved) != fp


def test_entry_points_default_to_cuda_and_mesh_is_queued():
    """The default device is CUDA, with a mesh too (make_mesh() raises
    without a GPU); a mesh of CPU coordinates runs on the CPU (its home
    device) without device="cpu"."""
    ts = unroll_scene()
    cfg = ttrace.TraceConfig(seed=0, max_depth=2, shadow_samples=1)
    img, spp = tadaptive.render_adaptive(
        ts, cfg=cfg, mesh=tparallel.make_mesh(["cpu"] * 2),
        **dict(KW, max_spp=4, min_spp=4))
    assert img.shape == (H, W, 3) and (spp[spp > 0] == 4).all()
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tadaptive.render_adaptive(ts, **KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tadaptive.render_adaptive(ts, mesh=tparallel.make_mesh(), **KW)


@pytest.mark.parametrize("accum", ["host", "device"])
def test_mesh_matches_jax(accum):
    """render_adaptive over 8 CPU coordinates against the JAX package's
    over its 8-device mesh (engine jnp), under test_adaptive_matches_jax's
    gates; and equal to the port's unsharded run bit for bit (a pixel's
    batch stays on one coordinate)."""
    from raytrace_tpu import parallel as jparallel
    js = jscene.from_dict(golden_dict("spheres_metal_glass"))[0]
    ts = carry(js)
    jcfg, tcfg = configs("spheres_metal_glass")
    img_j, spp_j = jadaptive.render_adaptive(
        js, cfg=jcfg, engine="jnp", accum=accum, pad_quantum=256,
        mesh=jparallel.make_mesh(), **KW)
    img_t, spp_t = tadaptive.render_adaptive(
        ts, cfg=tcfg, accum=accum, mesh=tparallel.make_mesh(["cpu"] * 8),
        **KW)
    act = spp_j > 0
    assert act.any() and (~act).any()
    assert (spp_t[act] == spp_j[act]).mean() >= 0.999
    extra = ~act & (spp_t > 0)
    assert (spp_t[extra] == KW["min_spp"]).all()
    assert (spp_t > KW["min_spp"]).any()
    gate(img_t, img_j)
    img_1, spp_1 = tadaptive.render_adaptive(ts, cfg=tcfg, accum=accum,
                                             device="cpu", **KW)
    np.testing.assert_array_equal(spp_t, spp_1)
    np.testing.assert_array_equal(img_t, img_1)


def test_renderer_adaptive_wrapper():
    ts = unroll_scene()
    r = trender.Renderer(device="cpu")
    r.set_samples(16)
    r.set_max_depth(3)
    img, spp = r.render_adaptive(ts, W, H, min_spp=4, rel_tol=0.05)
    assert img.dtype == np.uint8 and img.shape == (H, W, 3)
    assert spp.dtype == np.int32 and spp.shape == (H, W)
    assert spp.max() <= 16 and (spp[spp > 0] >= 4).all()
    assert r.benchmark_data.samples == float(spp.mean())
    img_dn, spp_dn = r.render_adaptive(ts, W, H, min_spp=4, rel_tol=0.05,
                                       denoise=True)
    np.testing.assert_array_equal(spp_dn, spp)
    assert img_dn.dtype == np.uint8 and not np.array_equal(img_dn, img)
    cfg_blk = tscene.SceneConfig(renderer={"softShadows": False,
                                           "recursiveReflections": False,
                                           "samples": 8})
    r2 = trender.Renderer(device="cpu")
    r2.render_adaptive(ts, W, H, scene_config=cfg_blk, min_spp=4)
    assert (r2.soft_shadows, r2.recursive_reflections, r2.samples) == (
        False, False, 8)


def test_cli_adaptive_denoise(tmp_path, capsys):
    import json
    out = tmp_path / "out.png"
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(golden_dict("spheres_metal_glass")))
    rc = cli.main([str(scene), str(out), "16", "12", "--samples", "8",
                   "--max-depth", "3", "--adaptive", "--min-spp", "4",
                   "--adaptive-tol", "0.05", "--denoise", "--device",
                   "cpu"])
    assert rc == 0 and out.exists()
    assert (tmp_path / "benchmark_data.json").exists()
    text = capsys.readouterr().out
    assert "Adaptive sampling: mean " in text
    assert "(cap 8, floor 4)" in text
    assert os.path.getsize(out) > 0
