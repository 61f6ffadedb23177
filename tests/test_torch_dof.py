"""Thin-lens depth of field in the port: the lens rays, the mask's DoF
branch (K2, K6, K6-stream through their plain version) and DoF renders.

* Rays: camera.thin_lens_perturb against raytrace_tpu.camera's on the
  same input rays and lanes, from both cameras: within 2 ulp (the JAX
  package's norm may sum in another order; XLA's division and square root
  round as the port's do).
* The mask's DoF branch takes a corrected bound, a deliberate departure
  from the JAX kernel, whose leaf slack is not conservative (see
  csrc/pixel_mask.cu): so the port's DoF mask must be a SUPERSET of
  pixel_mask_pallas(..., interpret=True) with DoF, at 12x8 (L=0.25, F=5;
  the one Pallas call of this file).
* Conservative against the dense plain path: at 40x30 with 256 lens
  samples a pixel (L=0.25, F=5, and the Go default L=0.1, F=10), every
  pixel that some sample's primary ray hits (the exact any-hit) lies in
  the mask - K2 (unroll), K6 (bvh) and K6-stream (a bvh scene forced into
  stream mode); and with a camera up of length 4 (F=5, L=0.25 unroll,
  L=1 bvh), whose lens offsets reach 4L.
* Renders: render_wavefront with DoF against the JAX jnp engine's
  render_band at 32x24 under the goldens gate (at most 0.1% of pixels off
  by more than 1e-3, mean abs error < 1e-4), unroll and bvh.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import make_goldens
from raytrace_tpu import camera as jcam
from raytrace_tpu import renderer as jrender
from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu.ops import megakernel as jmk
from raytrace_tpu_torch import camera as tcam
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench.suite import bvh_scene_dict
from raytrace_tpu_torch.ops import intersect as tisect
from raytrace_tpu_torch.ops import megakernel as tmk
from test_torch_scene import one_torch_thread  # noqa: F401


def golden_dict(name):
    return {n: d for n, d, _ in make_goldens.scenes()}[name]


def dof(L, F, **kw):
    return (jtrace.TraceConfig(depth_of_field=True, dof_lens_radius=L,
                               dof_focus_distance=F, **kw),
            ttrace.TraceConfig(depth_of_field=True, dof_lens_radius=L,
                               dof_focus_distance=F, **kw))


@pytest.mark.parametrize("go_camera", [True, False], ids=["go", "lookat"])
def test_thin_lens_rays_match(go_camera):
    d = golden_dict("prism_perfectmirror")
    d["camera"]["lookAt"] = [0.3, 0.2, -1.0]
    d["camera"]["up"] = [0.1, 1.0, 0.0]
    js = jscene.from_dict(d)[0]
    ts = tscene.from_dict(d, device="cpu")[0]
    rng = np.random.default_rng(3)
    n = 4096
    u = rng.uniform(0, 1, n).astype(np.float32)
    v = rng.uniform(0, 1, n).astype(np.float32)
    pix = rng.integers(0, 1 << 20, n).astype(np.uint32)
    samp = rng.integers(0, 64, n).astype(np.uint32)
    jr = jcam.go_rays if go_camera else jcam.lookat_rays
    tr = tcam.go_rays if go_camera else tcam.lookat_rays
    jo, jd = jr(js.camera, jnp.asarray(u), jnp.asarray(v))
    to, td = tr(ts.camera, torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    # the lens on the same input rays: its own arithmetic alone
    to = torch.from_numpy(np.array(jo))
    td = torch.from_numpy(np.array(jd))
    for L, F in ((0.1, 10.0), (0.25, 5.0)):
        ro, rd = jcam.thin_lens_perturb(js.camera, jo, jd, jnp.asarray(pix),
                                        jnp.asarray(samp), 7, L, F)
        go, gd = tcam.thin_lens_perturb(
            ts.camera, to, td, torch.from_numpy(pix.astype(np.int64)),
            torch.from_numpy(samp.astype(np.int64)), 7, L, F)
        np.testing.assert_array_max_ulp(go.numpy(), np.asarray(ro), 2)
        np.testing.assert_array_max_ulp(gd.numpy(), np.asarray(rd), 2)
        assert float(np.abs(go.numpy() - np.asarray(jo)).max()) > 1e-3


def test_dof_mask_is_superset_of_pallas_interpret():
    W, H = 12, 8
    d = golden_dict("cubes_dielectric_plane")   # spheres, boxes, a plane
    d["camera"]["position"] = [0, 1, 3]
    js = jscene.from_dict(d)[0]
    ts = tscene.from_dict(d, device="cpu")[0]
    jcfg, tcfg = dof(0.25, 5.0)
    pix = np.arange(W * H, dtype=np.uint32)
    ref = np.asarray(jmk.pixel_mask_pallas(
        js, jnp.asarray((pix % W).astype(np.float32)),
        jnp.asarray((pix // W).astype(np.float32)), width=W, height=H,
        cfg=jcfg, interpret=True)) > 0.0
    got = tmk.pixel_mask_plain(ts, width=W, height=H, cfg=tcfg).numpy()
    assert ref.any() and (~ref).any(), "the frame must mix hits and misses"
    assert not (ref & ~got).any(), "the port's DoF mask dropped a pixel"
    # the pinhole mask is a subset of the DoF mask
    pin = tmk.pixel_mask_plain(ts, width=W, height=H,
                               cfg=ttrace.TraceConfig()).numpy()
    assert not (pin & ~got).any()


def _scene(mode, monkeypatch):
    if mode == "unroll":
        d = golden_dict("cubes_dielectric_plane")
        return tscene.from_dict(d, device="cpu")[0]
    if mode == "stream":
        # a bvh scene forced into stream mode (the limit lowered in both
        # modules before the build attaches the stream table)
        monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 64)
        monkeypatch.setattr(tscene, "MAX_BVH_KERNEL_PRIMS", 64)
    return tscene.from_dict(bvh_scene_dict("mixed-noground"),
                            device="cpu")[0]


# (mode, camera up, lenses): the lens offset rd.x * up + rd.y *
# unit(LookAt x Up) takes the scene's up as given, so with |up| = 4 it
# reaches 4L, past the sqrt(2) L that bounds it for a unit up (a mask on
# that bound drops pixels of both long-up frames)
_LENSES = ((0.25, 5.0), (0.1, 10.0))
_CONSERVATIVE = [
    pytest.param("unroll", None, _LENSES, id="unroll"),
    pytest.param("bvh", None, _LENSES, id="bvh"),
    pytest.param("stream", None, _LENSES, id="stream"),
    pytest.param("unroll", 4.0, ((0.25, 5.0),), id="unroll-long-up"),
    pytest.param("bvh", 4.0, ((1.0, 5.0),), id="bvh-long-up"),
]


@pytest.mark.parametrize("mode,up,lenses", _CONSERVATIVE)
def test_dof_mask_is_conservative(mode, up, lenses, monkeypatch):
    ts = _scene(mode, monkeypatch)
    assert tmk._kernel_mode(ts) == mode
    if up is not None:
        ts = dataclasses.replace(ts, camera=dataclasses.replace(
            ts.camera, up=torch.tensor([0.0, up, 0.0])))
    W, H, N = 40, 30, 256
    pix = torch.arange(W * H).repeat_interleave(N)
    samp = torch.arange(N).repeat(W * H)
    for L, F in lenses:
        cfg = dof(L, F)[1]
        mask = tmk.pixel_mask_plain(ts, width=W, height=H, cfg=cfg)
        o, d = trender._lane_rays(ts, pix, samp, width=W, height=H,
                                  cfg=cfg, go_camera=True)
        ch = 1 << 16
        hit = torch.cat([
            tisect.any_hit(ts.geometry, o[i:i + ch], d[i:i + ch], 1e-3,
                           tisect.BIG, accel=ts.accel, exact=True)
            for i in range(0, o.shape[0], ch)])
        dense = hit.reshape(W * H, N).any(1)
        assert dense.any() and (~dense).any()
        assert not (dense & ~mask).any(), (
            f"the DoF mask drops {int((dense & ~mask).sum())} hit pixels")


@pytest.mark.parametrize("mode", ["unroll", "bvh"])
def test_dof_render_meets_jnp_engine(mode):
    W, H, S = 32, 24, 2
    if mode == "unroll":
        d = golden_dict("spheres_metal_glass")
    else:
        d = bvh_scene_dict("mixed")
    js = jscene.from_dict(d)[0]
    ts = tscene.from_dict(d, device="cpu")[0]
    assert tmk._kernel_mode(ts) == mode
    jcfg, tcfg = dof(0.25, 5.0, max_depth=4, shadow_samples=4)
    ref = np.asarray(jrender.render_band(js, 0, width=W, height=H, band_h=H,
                                         samples=S, cfg=jcfg))
    got = trender.render_wavefront(ts, width=W, height=H, samples=S,
                                   cfg=tcfg).numpy()
    pin = trender.render_wavefront(
        ts, width=W, height=H, samples=S,
        cfg=dataclasses.replace(tcfg, depth_of_field=False)).numpy()
    assert float(np.abs(got - pin).mean()) > 1e-3, "DoF changed nothing"
    diff = np.abs(got - ref).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.001
    assert float(np.abs(got - ref).mean()) < 1e-4
