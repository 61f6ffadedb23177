"""The port's bvh-mode slice against the JAX package, on the CPU.

* Ring scenes: the port's ring_scene_dict equals the JAX package's.
* Tree: build_scene_bvh (through from_dict and through
  convert.scene_from_numpy) equals the JAX scene's accel exactly, on
  ring-100, ring-1000 and a mixed scene (spheres, a prism, a cube and a
  plane; 124 primitives).
* Walks: closest_hit(..., accel) and any_hit(..., accel) against the JAX
  package's on 4096 random rays: the same primitive and t within 1e-6,
  the same blocked bits. The JAX walks run under jax.disable_jit, op by
  op: compiled, XLA contracts multiply-adds and reorders the three-term
  sums, which moves t by up to 0.5% on grazing hits of the radius-1000
  ground sphere, while op by op both packages round identically. The
  walks also agree with the port's own brute force (no exact ties among
  random rays, so the box tie order never shows).
* Engine: trace.trace lane for lane against raytrace_tpu.trace.trace on
  2048 lanes at depth 6 in real bvh mode, atol 1e-5 (the JAX engine runs
  compiled here; the differences above stay far below 1e-5 in radiance).
* Mask: K6's plain version equals pixel_mask_pallas(..., interpret=True)
  in bvh mode at 12x8, 0/1 for 0/1, and covers every pixel that the JAX
  package's exact per-lane any-hit covers at 32x24, 4 spp.
* Slice: render_wavefront (mask, compaction, trace, segment-add) equals
  render_band under the goldens gate on ring-100.
* Dispatch: _kernel_mode equals the JAX package's at the tier edges; a
  4,097-sphere scene renders through the stream tier's plain path and
  equals render_band; past MAX_STREAM_KERNEL_PRIMS the port stays in
  stream mode, and raises only past MAX_STREAM_ROWS; the
  CLI renders a bvh scene.
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu import bvh as jbvh
from raytrace_tpu import renderer as jrender
from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu.bench.suite import ring_scene_dict as jring
from raytrace_tpu.ops import intersect as jisect
from raytrace_tpu.ops import megakernel as jmk
from raytrace_tpu_torch import bvh as tbvh
from raytrace_tpu_torch import cli
from raytrace_tpu_torch import convert
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench.suite import bvh_scene_dict, mixed_scene_dict
from raytrace_tpu_torch.bench.suite import ring_scene_dict
from raytrace_tpu_torch.ops import intersect as tisect
from raytrace_tpu_torch.ops import megakernel as tmk
from raytrace_tpu_torch.utils import image as timage

from test_torch_scene import jax_leaves, one_torch_thread  # noqa: F401
from test_torch_trace import camera_lanes

TREE = ("node_min", "node_max", "node_skip", "node_first", "node_count",
        "prim_index")


def both(name):
    d = bvh_scene_dict(name)
    return jscene.from_dict(d)[0], tscene.from_dict(d, device="cpu")[0]


@pytest.mark.parametrize("n", [10, 100, 1000])
def test_ring_scene_dict_matches(n):
    assert ring_scene_dict(n) == jring(n)


def assert_tree_equal(ta, ja):
    for f in TREE:
        want = np.asarray(getattr(ja, f))
        got = getattr(ta, f)
        assert got.dtype in (torch.float32, torch.int32), f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    assert ta.leaf_size == ja.leaf_size


@pytest.mark.parametrize("name", ["ring100", "ring1000", "mixed"])
def test_tree_equals_jax(name):
    js, ts = both(name)
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(js) == "bvh"
    assert_tree_equal(ts.accel, js.accel)


@pytest.mark.parametrize("name", ["ring100", "ring1000", "mixed"])
def test_tree_survives_scene_from_numpy(name):
    js, _ = both(name)
    acc = {f: np.asarray(getattr(js.accel, f)) for f in TREE}
    acc["leaf_size"] = js.accel.leaf_size
    ts = convert.scene_from_numpy(
        **jax_leaves(js), occl_tris=js.geometry.occl_tris,
        sph_count=js.sph_count, mesh_count=js.mesh_count, accel=acc,
        device="cpu")
    assert_tree_equal(ts.accel, js.accel)
    # and the port builds the same tree from the carried tables
    assert_tree_equal(tscene.with_accel(
        dataclasses.replace(ts, accel=None)).accel, js.accel)


def random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = (r.normal(0.0, 3.0, (n, 3)) + [0.0, 1.0, -4.0]).astype(np.float32)
    d = r.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    t_max = r.uniform(0.1, 20.0, n).astype(np.float32)
    return o, d, t_max


@pytest.mark.parametrize("name", ["ring100", "mixed"])
def test_closest_walk_matches_jax(name):
    js, ts = both(name)
    o, d, _ = random_rays(4096, 1)
    with jax.disable_jit():
        jt, jp = jbvh.traverse_closest(js.accel, js.geometry,
                                       jnp.asarray(o), jnp.asarray(d))
        jh = jisect.closest_hit(js.geometry, jnp.asarray(o), jnp.asarray(d),
                                accel=js.accel)
    tt, tp = tbvh.traverse_closest(ts.accel, ts.geometry, torch.from_numpy(o),
                                   torch.from_numpy(d))
    assert (tp >= 0).any() and (tp < 0).any()
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    th = tisect.closest_hit(ts.geometry, torch.from_numpy(o),
                            torch.from_numpy(d), accel=ts.accel)
    hit = np.asarray(jh.hit)
    np.testing.assert_array_equal(th.hit.numpy(), hit)
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(th.mat_id.numpy()[hit],
                                  np.asarray(jh.mat_id)[hit])
    np.testing.assert_array_equal(th.front_face.numpy()[hit],
                                  np.asarray(jh.front_face)[hit])


@pytest.mark.parametrize("name", ["ring100", "mixed"])
def test_any_walk_matches_jax(name):
    js, ts = both(name)
    o, d, t_max = random_rays(4096, 2)
    with jax.disable_jit():
        jb = jisect.any_hit(js.geometry, jnp.asarray(o), jnp.asarray(d),
                            1e-3, jnp.asarray(t_max), accel=js.accel)
    tb = tisect.any_hit(ts.geometry, torch.from_numpy(o),
                        torch.from_numpy(d), 1e-3, torch.from_numpy(t_max),
                        accel=ts.accel)
    assert tb.any() and (~tb).any()
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("name", ["ring100", "ring1000", "mixed"])
def test_walks_match_brute_force(name):
    ts = both(name)[1]
    o, d, t_max = (torch.from_numpy(a) for a in random_rays(4096, 3))
    g = ts.geometry
    walk = tisect.closest_hit(g, o, d, accel=ts.accel)
    brute = tisect.closest_hit(g, o, d)
    assert torch.equal(walk.t, brute.t)
    assert torch.equal(walk.mat_id[walk.hit], brute.mat_id[brute.hit])
    for exact in (False, True):
        assert torch.equal(
            tisect.any_hit(g, o, d, 1e-3, t_max, accel=ts.accel,
                           exact=exact),
            tisect.any_hit(g, o, d, 1e-3, t_max, exact=exact))


@pytest.mark.parametrize("name", ["ring100", "mixed"])
def test_engine_lane_for_lane(name):
    js, ts = both(name)
    assert tmk._kernel_mode(ts) == "bvh"
    o, dd, pix, samp = camera_lanes(js, 32, 32, 2)   # 2048 lanes
    kw = dict(max_depth=6, shadow_samples=2)
    ref = np.asarray(jtrace.trace(js, jnp.asarray(o), jnp.asarray(dd),
                                  jnp.asarray(pix), jnp.asarray(samp),
                                  jtrace.TraceConfig(**kw)))
    got = ttrace.trace(ts, torch.from_numpy(o.copy()),
                       torch.from_numpy(dd.copy()),
                       torch.from_numpy(pix.astype(np.int64)),
                       torch.from_numpy(samp.astype(np.int64)),
                       ttrace.TraceConfig(**kw)).numpy()
    assert (ref.sum(-1) > 0).mean() > 0.3
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_k6_plain_matches_pallas_interpret():
    """ring-100 without its ground sphere: the camera sits inside the
    ground's bounding sphere, which marks every pixel of a ring scene."""
    W, H = 12, 8
    js, ts = both("ring100-noground")
    assert jmk._kernel_mode(js) == tmk._kernel_mode(ts) == "bvh"
    pix = np.arange(W * H, dtype=np.uint32)
    ref = np.asarray(jmk.pixel_mask_pallas(
        js, jnp.asarray((pix % W).astype(np.float32)),
        jnp.asarray((pix // W).astype(np.float32)), width=W, height=H,
        cfg=jtrace.TraceConfig(), interpret=True)) > 0.0
    got = tmk.pixel_mask_plain(ts, width=W, height=H,
                               cfg=ttrace.TraceConfig()).numpy()
    assert ref.any() and (~ref).any(), "the frame must mix hits and misses"
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["ring100", "ring100-noground", "mixed",
                                  "mixed-noground"])
def test_k6_plain_is_conservative(name):
    W, H, S = 32, 24, 4
    js, ts = both(name)
    exact, _, _ = jrender._pixel_mask(js, width=W, height=H, samples=S,
                                      cfg=jtrace.TraceConfig(max_depth=1),
                                      go_camera=True)
    exact = np.asarray(exact)
    got = tmk.pixel_mask_plain(ts, width=W, height=H,
                               cfg=ttrace.TraceConfig()).numpy()
    assert exact.any()
    assert not (exact & ~got).any(), "the cone mask dropped a hit pixel"


def test_wavefront_equals_dense_bvh():
    ts = both("ring100")[1]
    cfg = ttrace.TraceConfig(max_depth=6, shadow_samples=4)
    kw = dict(width=16, height=12, samples=2, cfg=cfg)
    wf = trender.render_wavefront(ts, **kw).numpy()
    dense = trender.render_band(ts, 0, band_h=12, **kw).numpy()
    assert (dense.sum(-1) > 0).mean() > 0.3
    diff = np.abs(wf - dense).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.001
    assert float(np.abs(wf - dense).mean()) < 1e-4


def test_bvh_wrappers_take_plain_versions_on_cpu():
    ts = both("mixed")[1]
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=2)
    tmk.reset_launches()
    assert torch.equal(tmk.pixel_mask(ts, width=8, height=6, cfg=cfg),
                       tmk.pixel_mask_plain(ts, width=8, height=6, cfg=cfg))
    o = torch.tensor([[0.0, 1.0, 8.0]]).repeat(4, 1)
    d = torch.tensor([[0.1, -0.1, -1.0]]).repeat(4, 1)
    i = torch.arange(4)
    assert torch.equal(tmk.trace(ts, o, d, i, i, cfg),
                       ttrace.trace(ts, o, d, i, i, cfg))
    assert not any(tmk.LAUNCHES.values()), tmk.LAUNCHES


def test_pack_bvh_tables_match_jax():
    js, ts = both("mixed")
    for inflate in (0.0, 1e-3):
        jn, jp = (np.asarray(a) for a in jmk.pack_bvh_tables(js.accel,
                                                             inflate))
        tn, tp = tmk.pack_bvh_tables(ts.accel, inflate)
        np.testing.assert_array_equal(tn.numpy(), jn.T)
        np.testing.assert_array_equal(tp.numpy(), jp[0])


def spheres_dict(n):
    return {"objects": [{"type": "sphere", "position": [i % 64, i // 64, -5],
                         "radius": 0.2} for i in range(n)]}


@pytest.mark.parametrize("n", [5, 96, 97, 1001, 4096, 4097])
def test_kernel_mode_matches_jax(n):
    d = spheres_dict(n)
    js = jscene.from_dict(d)[0]
    ts = tscene.from_dict(d, device="cpu")[0]
    assert (ts.accel is None) == (js.accel is None)
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(js)
    assert tmk.scene_fits_kernel(ts) == jmk.scene_fits_kernel(js)
    if ts.accel is not None:
        assert ts.accel.leaf_size == js.accel.leaf_size


@pytest.fixture(scope="module")
def stream_4097():
    ts = tscene.from_dict(spheres_dict(4097), device="cpu")[0]
    assert tmk._kernel_mode(ts) == "stream"
    assert ts.accel.stream_tab is not None
    return ts


def test_stream_scenes_render(stream_4097):
    """A 4,097-sphere scene renders through the stream tier's plain path
    (K6-stream's and K5's plain versions) and equals the dense path."""
    ts = dataclasses.replace(stream_4097, camera=dataclasses.replace(
        stream_4097.camera, position=torch.tensor([32.0, 32.0, -1.0])))
    r = trender.Renderer(device="cpu")
    r.set_samples(1)
    r.set_max_depth(3)
    img = r.render_linear(ts, 4, 3)
    ref = trender.render_band(ts, 0, width=4, height=3, band_h=3, samples=1,
                              cfg=r.trace_config()).numpy()
    assert (img.sum(-1) > 0).any()
    np.testing.assert_array_equal(img, ref)
    assert r.render(ts, 4, 3).shape == (3, 4, 3)


def test_past_stream_cap_raises(stream_4097, monkeypatch):
    """Past MAX_STREAM_KERNEL_PRIMS primitives (the JAX package's cap,
    lowered here below the scene's 4,097 primitives) the port stays in
    stream mode and renders; it raises only past MAX_STREAM_ROWS, the
    stream node table's limit, naming it."""
    monkeypatch.setattr(tmk, "MAX_STREAM_KERNEL_PRIMS", 4096)
    ts = stream_4097
    assert not tmk.scene_fits_kernel(ts)
    assert tmk.require_mode(ts) == "stream"
    r = trender.Renderer(device="cpu")
    r.set_samples(1)
    r.set_max_depth(2)
    assert r.render(ts, 4, 3).shape == (3, 4, 3)
    monkeypatch.setattr(tmk, "MAX_STREAM_ROWS", 4096)
    with pytest.raises(ValueError, match="float32"):
        r.render(ts, 4, 3)
    with pytest.raises(ValueError, match="float32"):
        tmk.pixel_mask(ts, width=4, height=3, cfg=ttrace.TraceConfig())
    o = torch.tensor([[0.0, 1.0, 8.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    i = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="float32"):
        tmk.trace(ts, o, d, i, i, ttrace.TraceConfig())


def test_cli_renders_bvh_scene(tmp_path):
    path = tmp_path / "mixed.json"
    path.write_text(json.dumps(mixed_scene_dict()))
    out = tmp_path / "out.png"
    assert cli.main([str(path), str(out), "12", "9", "--samples", "1",
                     "--max-depth", "2", "--device", "cpu"]) == 0
    img = timage.read_png(str(out))
    assert img.shape == (9, 12, 3)
    assert (img.sum(-1) > 0).any()
