"""The port's staged pipeline against the JAX package's
(raytrace_tpu.pipeline), on the CPU at the JAX test's size (12x8, 2 spp,
depth 3).

* Each stage against its JAX counterpart on the same lanes: the rays and
  the hits at atol 1e-6; the shade stage lane for lane at atol 1e-6 on
  every lane (radiance, throughput, next rays and alive; the port runs
  the bounce on the live lanes and scatters back, and a dead lane keeps
  what the JAX stage leaves it), at bounce 0 and at bounce 1 from a
  carried wavefront with dead lanes, with and without fast_mc's roulette
  and with recursion off.
* run_pipeline against JAX run_pipeline under the goldens gate (at most
  0.1% of pixels off by more than 1e-3, mean abs error < 1e-4), and
  against the port's eager engine at atol 1e-5 (the JAX test's).
* The hand-driven multi-bounce carry against the port's trace.trace at
  atol 1e-6; a broken intersect stage (no hits) shades to zero.
* AdaptivePipeline with fixed batches equals render_with_checkpoints
  (rtol 1e-6, atol 1e-7, the JAX test's).
* trace._bounce with hit=None gives what it gives with the hit computed
  outside, bit for bit.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytrace_tpu as jrt
from raytrace_tpu import pipeline as jpipe
from raytrace_tpu import trace as jtrace
from raytrace_tpu_torch import pipeline as tpipe
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench.suite import golden_scene_dict
from raytrace_tpu_torch.ops import intersect as tisect
from raytrace_tpu_torch.parallel import render_with_checkpoints
from test_torch_scene import one_torch_thread  # noqa: F401

W, H, SPP = 12, 8, 2
JCFG = jtrace.TraceConfig(max_depth=3, shadow_samples=2)
TCFG = ttrace.TraceConfig(max_depth=3, shadow_samples=2)
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def scenes(simple_scene_dict):
    """The JAX test's one-sphere scene and a golden scene with metal, glass
    and a plane (bench/suite.py's copy of tests/make_goldens.py's)."""
    out = {}
    for name, d in (("simple", simple_scene_dict),
                    ("metal_glass",
                     golden_scene_dict("spheres_metal_glass")[0])):
        out[name] = (jrt.scene_from_dict(d)[0],
                     tscene.from_dict(d, device="cpu")[0])
    return out


def _lanes():
    n_px = W * H
    jpix = jnp.repeat(jnp.arange(n_px, dtype=jnp.uint32), SPP)
    jsamp = jnp.tile(jnp.arange(SPP, dtype=jnp.uint32), n_px)
    tpix, tsamp = trender._lane_ids(torch.arange(n_px), SPP)
    return jpix, jsamp, tpix, tsamp


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or TOL))


def _same_rays(got, want):
    _close(got.origin, want.origin)
    _close(got.direction, want.direction)
    np.testing.assert_array_equal(got.pix_id.numpy(), np.asarray(want.pix_id))
    np.testing.assert_array_equal(got.samp_id.numpy(),
                                  np.asarray(want.samp_id))


def _same_shade(got, want):
    _close(got.radiance, want.radiance)
    _close(got.throughput, want.throughput)
    _same_rays(got.next_rays, want.next_rays)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))


CFGS = {
    "default": {},
    "fast_mc": dict(russian_roulette_start=0, throughput_epsilon=0.05),
    "no_recursion": dict(recursive_reflections=False),
}


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
@pytest.mark.parametrize("name", ["simple", "metal_glass"])
def test_stages_match_jax(scenes, name, cfg_name):
    js, ts = scenes[name]
    jcfg = dataclasses.replace(JCFG, **CFGS[cfg_name])
    tcfg = dataclasses.replace(TCFG, **CFGS[cfg_name])
    jpix, jsamp, tpix, tsamp = _lanes()
    jr = jpipe.generate_rays(js, jpix, jsamp, width=W, height=H, cfg=jcfg)
    tr = tpipe.generate_rays(ts, tpix, tsamp, width=W, height=H, cfg=tcfg)
    _same_rays(tr, jr)
    jh, th = jpipe.intersect_rays(js, jr), tpipe.intersect_rays(ts, tr)
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(jh.hit))
    hit = th.hit.numpy()
    for f in ("t", "point", "normal"):
        _close(getattr(th, f)[hit], np.asarray(getattr(jh, f))[hit])
    np.testing.assert_array_equal(th.mat_id.numpy()[hit],
                                  np.asarray(jh.mat_id)[hit])
    js0 = jpipe.shade_hits(js, jr, jh, bounce=0, cfg=jcfg)
    ts0 = tpipe.shade_hits(ts, tr, th, bounce=0, cfg=tcfg)
    _same_shade(ts0, js0)
    # bounce 1 from the carried wavefront: dead lanes keep their state
    jh1 = jpipe.intersect_rays(js, js0.next_rays)
    th1 = tpipe.intersect_rays(ts, ts0.next_rays)
    js1 = jpipe.shade_hits(js, js0.next_rays, jh1, bounce=1, cfg=jcfg,
                           throughput=js0.throughput,
                           radiance=js0.radiance, alive=js0.alive)
    ts1 = tpipe.shade_hits(ts, ts0.next_rays, th1, bounce=1, cfg=tcfg,
                           throughput=ts0.throughput,
                           radiance=ts0.radiance, alive=ts0.alive)
    _same_shade(ts1, js1)
    if cfg_name == "default":
        assert bool(ts0.alive.any()) and not bool(ts0.alive.all())


def _gate(img, ref):
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff > 1e-3).mean() <= 1e-3
    assert np.abs(img - ref).mean() < 1e-4


@pytest.mark.parametrize("name", ["simple", "metal_glass"])
def test_run_pipeline(scenes, name):
    js, ts = scenes[name]
    img = tpipe.run_pipeline(ts, width=W, height=H, samples=SPP, cfg=TCFG)
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    want = np.asarray(jpipe.run_pipeline(js, width=W, height=H,
                                         samples=SPP, cfg=JCFG))
    _gate(img.numpy(), want)
    r = trender.Renderer(device="cpu")
    r.engine, r.samples, r.max_depth = "eager", SPP, 3
    r.soft_shadows, r.seed = True, 0
    ref = trender.render_band(ts, 0, width=W, height=H, band_h=H,
                              samples=SPP, cfg=TCFG)
    _close(img, ref, atol=1e-5, rtol=0)
    assert float(img.sum()) > 0.0


def test_staged_carry_matches_trace_and_broken_hit(scenes):
    _, ts = scenes["metal_glass"]
    _, _, pix, samp = _lanes()
    rays = tpipe.generate_rays(ts, pix, samp, width=W, height=H, cfg=TCFG)
    thr = rad = alive = None
    cur = rays
    for b in range(TCFG.max_depth):
        hit = tpipe.intersect_rays(ts, cur)
        sh = tpipe.shade_hits(ts, cur, hit, bounce=b, cfg=TCFG,
                              throughput=thr, radiance=rad, alive=alive)
        thr, rad, alive = sh.throughput, sh.radiance, sh.alive
        cur = sh.next_rays
    ref = ttrace.trace(ts, rays.origin, rays.direction, pix, samp, TCFG)
    _close(rad, ref)
    # the shade stage takes the intersect stage's output: no hits, no light
    hit0 = tpipe.intersect_rays(ts, rays)
    broken = hit0._replace(hit=torch.zeros_like(hit0.hit))
    sh0 = tpipe.shade_hits(ts, rays, broken, bounce=0, cfg=TCFG)
    assert float(sh0.radiance.abs().sum()) == 0.0
    assert not bool(sh0.alive.any())


def test_adaptive_pipeline_accumulates(scenes):
    _, ts = scenes["simple"]
    r = trender.Renderer(device="cpu")
    r.max_depth = 3
    ap = tpipe.AdaptivePipeline(target_seconds=0.05, batch=2, min_batch=2,
                                max_batch=2)
    img = ap.render(r, ts, W, H, total_samples=6)
    assert img.shape == (H, W, 3) and (r.samples, r.seed) == (100, 0)
    r2 = trender.Renderer(device="cpu")
    r2.max_depth = 3
    ref = render_with_checkpoints(r2, ts, W, H, total_samples=6,
                                  samples_per_round=2)
    assert np.isfinite(img).all() and img.max() > 0
    np.testing.assert_allclose(img, ref, rtol=1e-6, atol=1e-7)


def test_bounce_given_hit_is_unchanged(scenes):
    _, ts = scenes["metal_glass"]
    _, _, pix, samp = _lanes()
    o, d = trender._lane_rays(ts, pix, samp, width=W, height=H, cfg=TCFG,
                              go_camera=True)
    tp = torch.ones_like(o)
    own = ttrace._bounce(ts, pix, samp, TCFG, 0, o, d, tp)
    hit = tisect.closest_hit(ts.geometry, o, d, t_min=1e-3, accel=ts.accel)
    given = ttrace._bounce(ts, pix, samp, TCFG, 0, o, d, tp, hit=hit)
    for a, b in zip(own, given):
        assert torch.equal(a, b)
