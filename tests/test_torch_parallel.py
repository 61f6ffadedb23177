"""The port's mesh and sharded renders (raytrace_tpu_torch/parallel/) on
the CPU, held against the JAX package's (tests/test_parallel.py) on the
same scene dicts, mesh shapes, sizes and tolerances (atol/rtol 1e-5; the
wavefront against the jnp engine at atol 1e-4).

The JAX meshes run on the 8 virtual CPU devices of tests/conftest.py; the
port's on ``make_mesh(["cpu"] * 8, ...)``, eight coordinates on one
device. Covered: mesh shapes and errors (and ``make_mesh()`` raising
without a GPU); ``render_linear_sharded`` at (8,1), (4,2) and (2,4), with
uneven pixels and odd samples, against the JAX function on the same mesh
shape and against the port's own banded ``Renderer.render_linear``;
``render_wavefront_sharded`` in unroll mode and in bvh mode with a forced
split against the JAX package's jnp engine; its overflow; the plain
banded masks (K2, K6, K6-stream, K2 with depth of field) equal to the
full masks' rows; ``NodeStatus``, ``heartbeat``, ``DistributedRenderer``
and its stats, ``rerender_missing_rows``; the scaling sweep. No Pallas
kernel runs in interpret mode here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as rt
from raytrace_tpu import parallel as jparallel
from raytrace_tpu import renderer as jrenderer
from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu.ops import megakernel as jmk
from raytrace_tpu_torch import parallel as tparallel
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench import suite
from raytrace_tpu_torch.ops import megakernel as tmk
from test_torch_scene import one_torch_thread  # noqa: F401

JCFG = jtrace.TraceConfig(max_depth=5, shadow_samples=4)
TCFG = ttrace.TraceConfig(max_depth=5, shadow_samples=4)
TOL = dict(atol=1e-5, rtol=1e-5)

WAVE_DICT = {
    "camera": {"position": [0, 0, 8], "aspectRatio": 1.33},
    "objects": [
        {"type": "sphere", "position": [0, 0, 0], "radius": 1.0,
         "material": {"type": "metal", "color": [0.8, 0.8, 0.9],
                      "roughness": 0.1}},
        {"type": "sphere", "position": [-2, 0, 0], "radius": 0.7,
         "material": {"type": "glass", "color": [0.8, 0.2, 0.2]}},
    ],
    "lights": [{"type": "point", "position": [5, 5, 5],
                "color": [1, 1, 1], "intensity": 1.0}],
}


def cpu_mesh(px=None, sp=1, n=8):
    return tparallel.make_mesh(["cpu"] * n, px=px, sp=sp)


@pytest.fixture(scope="module")
def small(simple_scene_dict):
    """(JAX scene, port scene) of tests/test_parallel.py's small_scene."""
    return (rt.scene_from_dict(simple_scene_dict)[0],
            tscene.from_dict(simple_scene_dict, device="cpu")[0])


def ring_dict(ground: bool = True):
    """tests/test_parallel.py's bvh-mode scene: 12 spheres in a ring over a
    ground sphere (without it, its mask holds hits and misses)."""
    objs = [{"type": "sphere", "position": [0, -1000.5, 0], "radius": 1000,
             "material": {"type": "lambertian", "color": [0.5, 0.5, 0.5]}}]
    objs = objs if ground else []
    for i in range(12):
        a = 2 * math.pi * i / 12
        objs.append({"type": "sphere",
                     "position": [3 * math.cos(a), 0.0, 3 * math.sin(a)],
                     "radius": 0.5,
                     "material": {"type": ["lambertian", "metal",
                                           "glass"][i % 3],
                                  "color": [0.7, 0.5, 0.4],
                                  "roughness": 0.1}})
    return {"camera": {"position": [0, 2, 9], "aspectRatio": 1.0},
            "objects": objs,
            "lights": [{"type": "point", "position": [4, 8, 3],
                        "color": [1, 1, 1], "intensity": 2.0}]}


def test_mesh_shapes_and_errors():
    m = cpu_mesh(px=4, sp=2)
    assert m.shape == {"px": 4, "sp": 2} and m.size == 8
    assert m.axis_names == ("px", "sp")
    assert m.local_coords()[:3] == [(0, 0), (0, 1), (1, 0)]
    assert m.home == torch.device("cpu") and not m.multi_process
    assert cpu_mesh().shape == {"px": 8, "sp": 1}
    assert cpu_mesh(sp=4).shape == {"px": 2, "sp": 4}
    with pytest.raises(ValueError, match="px\\*sp"):
        cpu_mesh(px=3, sp=2)
    with pytest.raises(ValueError, match="not divisible"):
        cpu_mesh(sp=3)
    one = tparallel.single_device_mesh("cpu")
    assert one.shape == {"px": 1, "sp": 1}
    if torch.cuda.is_available():
        assert tparallel.make_mesh().devices.flat[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparallel.single_device_mesh()


@pytest.mark.parametrize("px,sp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_matches_jax(small, px, sp):
    """The port's band renderer on a (px, sp) mesh equals the JAX
    package's on the same mesh shape, and the port's one-coordinate mesh
    (every mesh shape gives the same image)."""
    js, ts = small
    kw = dict(samples=8)
    want = jparallel.render_linear_sharded(
        js, 32, 24, cfg=JCFG, mesh=jparallel.make_mesh(px=px, sp=sp), **kw)
    got = tparallel.render_linear_sharded(ts, 32, 24, cfg=TCFG,
                                          mesh=cpu_mesh(px, sp), **kw)
    assert got.shape == (24, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    one = tparallel.render_linear_sharded(
        ts, 32, 24, cfg=TCFG, mesh=tparallel.single_device_mesh("cpu"), **kw)
    np.testing.assert_allclose(got, one, **TOL)
    assert got.max() > 0


def test_sharded_matches_band_renderer(small):
    """The sharded path equals the port's banded Renderer (engine
    "eager": render_band) on an 8-coordinate mesh."""
    _, ts = small
    r = trender.Renderer(device="cpu")
    r.samples, r.max_depth, r.engine = 8, 5, "eager"
    ref = r.render_linear(ts, 32, 24)
    img = tparallel.render_linear_sharded(ts, 32, 24, samples=8,
                                          cfg=r.trace_config(),
                                          mesh=cpu_mesh())
    np.testing.assert_allclose(img, ref, **TOL)


@pytest.mark.parametrize("case", ["uneven_pixels", "odd_samples"])
def test_padding_matches_jax(small, case):
    """31x9 pixels over px=8 (padded pixels), and 5 spp over sp=4 (padded
    samples add zero), against the JAX function on the same mesh and
    against the unsharded image."""
    js, ts = small
    w, h, spp, px, sp = ((31, 9, 4, 8, 1) if case == "uneven_pixels"
                         else (16, 8, 5, 2, 4))
    want = jparallel.render_linear_sharded(
        js, w, h, samples=spp, cfg=JCFG,
        mesh=jparallel.make_mesh(px=px, sp=sp))
    got = tparallel.render_linear_sharded(ts, w, h, samples=spp, cfg=TCFG,
                                          mesh=cpu_mesh(px, sp))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    ref = trender.render_band(ts, 0, width=w, height=h, band_h=h,
                              samples=spp, cfg=TCFG).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_sharded_wavefront_matches_jnp():
    """The pixel-sharded wavefront (banded mask, compaction, trace, on each
    of 8 px shards) equals the JAX package's jnp engine, and the port's
    unsharded render_wavefront bit for bit (sp = 1)."""
    js = rt.scene_from_dict(WAVE_DICT)[0]
    ts = tscene.from_dict(WAVE_DICT, device="cpu")[0]
    jcfg = jtrace.TraceConfig(max_depth=3, shadow_samples=1)
    tcfg = ttrace.TraceConfig(max_depth=3, shadow_samples=1)
    img, ov = tparallel.render_wavefront_sharded(
        ts, width=16, height=16, samples=1, cfg=tcfg, mesh=cpu_mesh())
    assert ov.shape == () and int(ov) == 0
    r = rt.Renderer()
    r.engine, r.samples, r.max_depth = "jnp", 1, 3
    ref = r.render_linear(js, 16, 16)
    np.testing.assert_allclose(img.numpy(), ref, atol=1e-4)
    one = trender.render_wavefront(ts, width=16, height=16, samples=1,
                                   cfg=tcfg)
    assert torch.equal(img, one)


def test_sharded_wavefront_bvh_mode_matches_jnp(monkeypatch):
    """bvh mode (the unroll limit lowered to 8) with the ladder forced to
    split at bounce 2, on 8 px shards of one row each at capacity 8:
    equal to the JAX package's jnp trace of every lane."""
    d = ring_dict()
    js = jscene.with_accel(rt.scene_from_dict(d)[0])
    ts = tscene.from_dict(d, device="cpu", build_accel=True)[0]
    for mk in (jmk, tmk):
        monkeypatch.setattr(mk, "UNROLL_PRIM_LIMIT", 8)
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(js) == "bvh"
    jcfg = jtrace.TraceConfig(max_depth=6, shadow_samples=2)
    tcfg = ttrace.TraceConfig(max_depth=6, shadow_samples=2)
    seen = []
    real = trender.trace_with_split

    def spy(*a, **k):
        seen.append(k["split"])
        return real(*a, **k)

    monkeypatch.setattr(trender, "trace_with_split", spy)
    img, ov = tparallel.render_wavefront_sharded(
        ts, width=8, height=8, samples=1, cfg=tcfg, mesh=cpu_mesh(),
        px_capacity=8, split=2)
    assert int(ov) == 0 and seen == [2] * 8
    pix = jnp.arange(64, dtype=jnp.uint32)
    samp = jnp.zeros(64, dtype=jnp.uint32)
    o, dirs = jrenderer._lane_rays(js, pix, samp, width=8, height=8,
                                   cfg=jcfg, go_camera=True)
    ref = np.asarray(jtrace.trace(js, o, dirs, pix, samp, jcfg)
                     ).reshape(8, 8, 3)
    assert ref.max() > 0.0
    np.testing.assert_allclose(img.numpy(), ref, atol=1e-4)


def test_sharded_wavefront_overflow_detected():
    """A capacity of one pixel a shard where the sphere covers many: the
    overflow (a 0-d tensor, summed over the shards) is positive; the
    contract's errors."""
    d = {"camera": {"position": [0, 0, 3], "aspectRatio": 1.0},
         "objects": [{"type": "sphere", "position": [0, 0, 0],
                      "radius": 1.0,
                      "material": {"type": "lambertian",
                                   "color": [0.5, 0.5, 0.5]}}],
         "lights": [{"type": "point", "position": [0, 5, 5],
                     "color": [1, 1, 1], "intensity": 2.0}]}
    ts = tscene.from_dict(d, device="cpu")[0]
    cfg = ttrace.TraceConfig(max_depth=2, shadow_samples=1)
    kw = dict(width=16, height=16, samples=1, cfg=cfg)
    _, ov = tparallel.render_wavefront_sharded(ts, mesh=cpu_mesh(),
                                               px_capacity=1, **kw)
    assert ov.dtype == torch.int64 and int(ov) > 0
    with pytest.raises(ValueError, match="sp=1"):
        tparallel.render_wavefront_sharded(ts, mesh=cpu_mesh(4, 2), **kw)
    with pytest.raises(ValueError, match="must divide"):
        tparallel.render_wavefront_sharded(ts, mesh=cpu_mesh(n=3), **kw)


def mask_scenes(monkeypatch):
    """(name, port scene, cfg) of the four mask kernels' plain versions,
    one at a time (each lowers a mode limit for the next): K2 (unroll), K2
    with depth of field, K6 (bvh: the unroll limit lowered to 8) and
    K6-stream (the bvh limit lowered too)."""
    pinhole = ttrace.TraceConfig(max_depth=3)
    dof = ttrace.TraceConfig(max_depth=3, depth_of_field=True,
                             dof_lens_radius=0.25, dof_focus_distance=5.0)
    spheres = tscene.from_dict(WAVE_DICT, device="cpu")[0]
    yield "K2", spheres, pinhole
    yield "K2-dof", spheres, dof
    monkeypatch.setattr(tmk, "UNROLL_PRIM_LIMIT", 8)
    yield ("K6", tscene.from_dict(ring_dict(False), device="cpu",
                                  build_accel=True)[0], pinhole)
    monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 8)
    yield ("K6-stream", tscene.from_dict(ring_dict(False), device="cpu",
                                         build_accel=True)[0], pinhole)


def test_plain_banded_mask_equals_the_full_masks_rows(monkeypatch):
    """The plain banded masks of a 3-band split (rows 0-6, 7-13, 14-19 of a
    24x20 frame) equal the rows of the full mask bit for bit, in every
    mask mode; a band outside the image raises."""
    w, h = 24, 20
    for name, s, cfg in mask_scenes(monkeypatch):
        mode = tmk.require_mode(s)
        assert mode == {"K2": "unroll", "K2-dof": "unroll", "K6": "bvh",
                        "K6-stream": "stream"}[name]
        full = tmk.pixel_mask_plain(s, width=w, height=h, cfg=cfg)
        assert full.any() and (~full).any(), name
        parts = [tmk.pixel_mask(s, width=w, height=h, cfg=cfg, row0=r0,
                                rows=n)
                 for r0, n in ((0, 7), (7, 7), (14, 6))]
        assert [p.shape[0] for p in parts] == [7 * w, 7 * w, 6 * w]
        assert torch.equal(torch.cat(parts), full), name
    with pytest.raises(ValueError, match="not inside"):
        tmk.pixel_mask_plain(s, width=w, height=h, cfg=cfg, row0=15, rows=6)


def test_node_status_and_heartbeat(monkeypatch):
    """One process: process_count 1; the local devices are the CUDA ones
    (none here: not available), or those of a group."""
    st = tparallel.NodeStatus.collect()
    assert st.process_count == 1 and st.process_id == 0
    assert st.available == torch.cuda.is_available()
    monkeypatch.setattr(tparallel.mesh, "local_devices",
                        lambda: [torch.device("cpu")])
    st = tparallel.NodeStatus.collect()
    assert st.available and st.platform == "cpu"
    assert st.local_devices == st.global_devices == 1
    hb = tparallel.heartbeat()
    assert hb.shape == (1,) and hb[0] == 1.0


def test_distributed_renderer_stats(small):
    _, ts = small
    d = tparallel.DistributedRenderer(mesh=cpu_mesh())
    img = d.render_linear(ts, 16, 8, samples=4, cfg=TCFG)
    assert img.shape == (8, 16, 3) and img.max() > 0
    with pytest.raises(AttributeError):  # no scene: a failed job
        d.render_linear(None, 16, 8, samples=4, cfg=TCFG)
    s = d.get_stats()
    assert s["completed_jobs"] == 1 and s["failed_jobs"] == 1
    assert s["success_rate"] == 0.5 and s["devices"] == 8
    assert s["total_nodes"] == s["available_nodes"] == 1


def test_elastic_rerender_missing_rows(small):
    """A lost band (rows 3-6) rendered again by rerender_missing_rows
    equals the uninterrupted render bit for bit (every draw is keyed by
    (pixel, sample))."""
    _, ts = small
    r = trender.Renderer(device="cpu")
    r.samples, r.max_depth, r.engine = 4, 5, "eager"
    full = r.render_linear(ts, 16, 12)
    damaged = full.copy()
    damaged[3:7] = -1.0
    fixed = tparallel.rerender_missing_rows(r, ts, damaged, [5, 3, 4, 6],
                                            16, 12)
    np.testing.assert_array_equal(fixed, full)


def test_scaling_benchmark_on_cpu_coordinates(monkeypatch):
    """The sweep over four CPU coordinates (the local devices patched):
    sizes past the device count are cut."""
    monkeypatch.setattr(tparallel.mesh, "local_devices",
                        lambda: [torch.device("cpu")] * 4)
    out = suite.scaling_benchmark(width=16, height=12, samples=2,
                                  mesh_shapes=(1, 2, 4, 8))
    assert out["shapes"] == [1, 2, 4]
    assert all(t > 0 for t in out["times"]) and out["efficiency"][0] == 1.0
