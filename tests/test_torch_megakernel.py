"""K1 and K2 of the port, through their plain versions, against the JAX
package's Pallas kernels run in interpret mode on the CPU.

* K2's plain version (megakernel.pixel_mask_plain) against
  pixel_mask_pallas(..., interpret=True) on a 12x8 frame: equal, 0/1 for
  0/1 - both run the same float32 cone test.
* K2 is conservative: its mask covers every pixel that the JAX package's
  exact per-lane any-hit (the CPU branch of renderer._pixel_mask) hits, on
  the slice scenes at 32x24 and 4 spp.
* K1's plain version (trace.trace) against trace_pallas(..., interpret=
  True) at 12x8, 1 spp, depth 3, with the tolerance that
  tests/test_megakernel.py:73 uses for the same comparison, atol=1e-4 (the
  Pallas kernel uses rsqrt normalisation and an exp2/log2 power, which
  round differently from the plain expressions).

Interpret-mode Pallas costs ~20 s a call, so there are exactly two.
The wrappers' own checks (device routing, scope cuts) close the file.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import make_goldens
from raytrace_tpu import camera as jcam
from raytrace_tpu import renderer as jrender
from raytrace_tpu import rng as jrng
from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu.ops import megakernel as jmk
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.ops import megakernel as tmk
from test_torch_scene import one_torch_thread  # noqa: F401

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")


def asset_dict(name):
    with open(os.path.join(ASSETS, f"{name}.json")) as f:
        d = json.load(f)
    d["camera"]["position"][2] = -d["camera"]["position"][2]
    return d


def golden_dict(name):
    return {n: d for n, d, _ in make_goldens.scenes()}[name]


def both(d):
    return jscene.from_dict(d)[0], tscene.from_dict(d, device="cpu")[0]


def test_k2_plain_matches_pallas_interpret():
    W, H = 12, 8
    d = golden_dict("cubes_dielectric_plane")   # spheres, boxes, a plane
    d["camera"]["position"] = [0, 1, 3]         # fill the small frame
    js, ts = both(d)
    pix = np.arange(W * H, dtype=np.uint32)
    ref = np.asarray(jmk.pixel_mask_pallas(
        js, jnp.asarray((pix % W).astype(np.float32)),
        jnp.asarray((pix // W).astype(np.float32)), width=W, height=H,
        cfg=jtrace.TraceConfig(), interpret=True)) > 0.0
    got = tmk.pixel_mask_plain(ts, width=W, height=H,
                               cfg=ttrace.TraceConfig()).numpy()
    assert ref.any() and (~ref).any(), "the frame must mix hits and misses"
    np.testing.assert_array_equal(got, ref)


CONSERVATIVE = ([("asset", n) for n in ("sphere_reflections_light",
                                        "two_red_cubes_scene",
                                        "final_silver_prism_purple_cube")]
                + [("golden", n) for n in ("spheres_metal_glass",
                                           "cubes_dielectric_plane",
                                           "prism_perfectmirror")])


@pytest.mark.parametrize("kind,name", CONSERVATIVE,
                         ids=[c[1] for c in CONSERVATIVE])
def test_k2_plain_is_conservative(kind, name):
    W, H, S = 32, 24, 4
    d = asset_dict(name) if kind == "asset" else golden_dict(name)
    js, ts = both(d)
    cfg = jtrace.TraceConfig(max_depth=1)
    exact, _, _ = jrender._pixel_mask(js, width=W, height=H, samples=S,
                                      cfg=cfg, go_camera=True)
    exact = np.asarray(exact)
    got = tmk.pixel_mask_plain(ts, width=W, height=H,
                               cfg=ttrace.TraceConfig()).numpy()
    assert exact.any()
    assert not (exact & ~got).any(), "the cone mask dropped a hit pixel"


def test_k1_plain_matches_pallas_interpret():
    W, H = 12, 8
    d = golden_dict("cubes_dielectric_plane")
    d["camera"]["position"] = [0, 1, 3]
    d["objects"].append({
        "type": "triangularPrism", "vertices": [
            [-1.0, 0.6, 0.5], [0.0, 1.4, 0.5], [1.0, 0.6, 0.5],
            [-1.0, 0.6, -0.5], [0.0, 1.4, -0.5], [1.0, 0.6, -0.5]],
        "material": {"type": "perfectmirror", "color": [0.9, 0.9, 0.95]}})
    d["objects"].append({"type": "sphere", "position": [0.9, -0.4, 1.2],
                         "radius": 0.25, "material": {
                             "type": "diffuselight", "color": [1, 0.9, 0.8]}})
    js, ts = both(d)
    jcfg = jtrace.TraceConfig(max_depth=3, shadow_samples=2)
    n = W * H
    pix = np.arange(n, dtype=np.uint32)
    samp = np.zeros(n, np.uint32)
    ju, jv, _, _ = jrng.uniform4(jnp.asarray(pix), jnp.asarray(samp), 0, 0)
    o, dd = jcam.go_rays(js.camera,
                         (jnp.asarray((pix % W).astype(np.float32)) + ju) / W,
                         (jnp.asarray((pix // W).astype(np.float32)) + jv)
                         / H)
    ref = np.asarray(jmk.trace_pallas(js, o, dd, jnp.asarray(pix),
                                      jnp.asarray(samp), jcfg,
                                      interpret=True))
    got = tmk.trace(
        ts, torch.from_numpy(np.asarray(o).copy()),
        torch.from_numpy(np.asarray(dd).copy()),
        torch.from_numpy(pix.astype(np.int64)),
        torch.from_numpy(samp.astype(np.int64)),
        ttrace.TraceConfig(max_depth=3, shadow_samples=2)).numpy()
    assert (ref.sum(-1) > 0).mean() > 0.5
    np.testing.assert_allclose(got, ref, atol=1e-4)


# -- wrappers ---------------------------------------------------------------

def test_wrappers_take_plain_versions_on_cpu():
    ts = tscene.from_dict(golden_dict("prism_perfectmirror"),
                          device="cpu")[0]
    cfg = ttrace.TraceConfig(max_depth=2, shadow_samples=2)
    tmk.reset_launches()
    m = tmk.pixel_mask(ts, width=8, height=6, cfg=cfg)
    assert torch.equal(m, tmk.pixel_mask_plain(ts, width=8, height=6,
                                               cfg=cfg))
    o = torch.zeros((4, 3)) + torch.tensor([0.0, 0.5, 6.0])
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    i = torch.arange(4)
    assert torch.equal(tmk.trace(ts, o, d, i, i, cfg),
                       ttrace.trace(ts, o, d, i, i, cfg))
    assert not any(tmk.LAUNCHES.values()), tmk.LAUNCHES


def test_large_scenes_raise():
    """Past 96 primitives without a scene BVH the scene no longer raises:
    the port runs K7 there (loop mode; on the CPU its plain version). The
    JAX package's kernel mode is loop too, but its Renderer sends such
    scenes to the brute-force jnp engine, which computes the same thing.
    The main path (mask, compaction, trace) equals the dense path."""
    objs = [{"type": "sphere", "position": [(i % 10) - 4.5, i // 10 - 4.5,
                                            -8], "radius": 0.45,
             "material": {"type": ("metal", "lambertian")[i % 2],
                          "color": [0.8, 0.5, 0.3]}} for i in range(97)]
    d = {"camera": {"position": [0, 0, -3], "aspectRatio": 1.0},
         "objects": objs, "lights": [{"position": [3, 5, 4],
                                      "intensity": 20.0}]}
    ts = tscene.from_dict(d, device="cpu", build_accel=False)[0]
    assert tmk._kernel_mode(ts) == "loop"
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(
        jscene.from_dict(d, build_accel=False)[0])
    cfg = ttrace.TraceConfig(max_depth=4, shadow_samples=2)
    kw = dict(width=12, height=12, samples=2, cfg=cfg)
    wf = trender.render_wavefront(ts, **kw).numpy()
    dense = trender.render_band(ts, 0, band_h=12, **kw).numpy()
    assert (dense.sum(-1) > 0).mean() > 0.2
    diff = np.abs(wf - dense).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.001
    assert float(np.abs(wf - dense).mean()) < 1e-4


def test_mask_dof_covers_pinhole_mask():
    """The mask takes depth of field (its thin-lens branch, on the CPU the
    plain version): a superset of the pinhole mask that grows with the
    lens."""
    ts = tscene.from_dict(asset_dict("sphere_reflections_light"),
                          device="cpu")[0]
    kw = dict(width=40, height=30)
    pin = tmk.pixel_mask(ts, cfg=ttrace.TraceConfig(), **kw)
    small = tmk.pixel_mask(ts, cfg=ttrace.TraceConfig(depth_of_field=True),
                           **kw)
    big = tmk.pixel_mask(ts, cfg=ttrace.TraceConfig(
        depth_of_field=True, dof_lens_radius=0.25, dof_focus_distance=5.0),
        **kw)
    assert not (pin & ~small).any() and not (small & ~big).any()
    assert int(big.sum()) > int(pin.sum())
