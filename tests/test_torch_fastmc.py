"""fast_mc in the port's engine: Russian roulette and the throughput cutoff
(trace.fast_mc), held to the JAX package.

* Against the JAX jnp engine (raytrace_tpu.trace) at 32x24, 2 spp, depth
  12, roulette from bounce 2 and the 1e-4 cutoff: the divergent-pixel
  fraction (pixels off by more than 1e-3) must be at most 1e-3
  (BENCHMARKS.md "Engine equivalence"). The JAX engine boosts a survivor
  by dividing by q, the port (and the JAX kernel, and the port's kernels)
  by multiplying by 1/q; the two round one ulp apart now and then, which
  moves a later roulette verdict only when the draw u lies within an ulp
  of q. The fraction found is printed.
* Lane for lane against trace_pallas(..., interpret=True) with fast_mc at
  12x8, 4 spp, depth 3, roulette from bounce 1 (so it bites): within the
  K1 interpret test's atol=1e-4 on every lane except those whose
  roulette draw u lies within 1e-5 of its q (the Pallas kernel's rsqrt
  normalisation and exp2/log2 power round differently, and such a lane
  may then take the other verdict). Those lanes are counted and printed.
* The Renderer's fast_mc settings (roulette from bounce 8, cutoff 1e-4)
  render, change the image little and end lanes early.
"""

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
from raytrace_tpu_torch import rng as trng
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from test_torch_scene import one_torch_thread  # noqa: F401


def golden_dict(name):
    return {n: d for n, d, _ in make_goldens.scenes()}[name]


def fast(**kw):
    return (jtrace.TraceConfig(**kw), ttrace.TraceConfig(**kw))


@pytest.mark.parametrize("name", ["spheres_metal_glass",
                                  "cubes_dielectric_plane"])
def test_fast_mc_engine_meets_jnp_engine(name):
    W, H, S = 32, 24, 2
    d = golden_dict(name)
    js = jscene.from_dict(d)[0]
    ts = tscene.from_dict(d, device="cpu")[0]
    jcfg, tcfg = fast(max_depth=12, shadow_samples=4,
                      russian_roulette_start=2, throughput_epsilon=1e-4)
    ref = np.asarray(jrender.render_band(js, 0, width=W, height=H, band_h=H,
                                         samples=S, cfg=jcfg))
    got = trender.render_band(ts, 0, width=W, height=H, band_h=H,
                              samples=S, cfg=tcfg).numpy()
    full = trender.render_band(ts, 0, width=W, height=H, band_h=H,
                               samples=S, cfg=ttrace.TraceConfig(
                                   max_depth=12, shadow_samples=4)).numpy()
    assert (got != full).any(), "fast_mc changed nothing"
    diff = np.abs(got - ref).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    print(f"{name}: divergent-pixel fraction {frac:.2e} "
          f"({int((diff > 1e-3).sum())} of {diff.size}), max {diff.max():.2e}")
    assert frac <= 1e-3


def test_fast_mc_matches_pallas_interpret(monkeypatch):
    W, H, S = 12, 8, 4
    d = golden_dict("cubes_dielectric_plane")
    d["camera"]["position"] = [0, 1, 3]   # fill the small frame
    js = jscene.from_dict(d)[0]
    ts = tscene.from_dict(d, device="cpu")[0]
    kw = dict(max_depth=3, shadow_samples=2, russian_roulette_start=1,
              throughput_epsilon=1e-4)
    jcfg, tcfg = fast(**kw)
    n = W * H * S
    pix = np.repeat(np.arange(W * H, dtype=np.uint32), S)
    samp = np.tile(np.arange(S, dtype=np.uint32), W * H)
    ju, jv, _, _ = jrng.uniform4(jnp.asarray(pix), jnp.asarray(samp), 0, 0)
    o, dd = jcam.go_rays(js.camera,
                         (jnp.asarray((pix % W).astype(np.float32)) + ju) / W,
                         (jnp.asarray((pix // W).astype(np.float32)) + jv)
                         / H)
    ref = np.asarray(jmk.trace_pallas(js, o, dd, jnp.asarray(pix),
                                      jnp.asarray(samp), jcfg,
                                      interpret=True))
    # the roulette draws the port's engine makes, with their q
    draws = []
    real = ttrace.fast_mc

    def spy(cfg, bounce, p, s, tp):
        go, out = real(cfg, bounce, p, s, tp)
        if (cfg.russian_roulette_start is not None
                and bounce >= cfg.russian_roulette_start):
            u = trng.uniform4(p, s, trng.bounce_stream(
                bounce, trng.Streams.RUSSIAN_ROULETTE), cfg.seed)[0]
            q = torch.clamp(torch.amax(tp, -1), min=0.05, max=1.0)
            draws.append((lane_of(p, s), (u - q).abs(), int((~go).sum())))
        return go, out

    lane_of = lambda p, s: p * S + s

    monkeypatch.setattr(ttrace, "fast_mc", spy)
    got = ttrace.trace(ts, torch.from_numpy(np.asarray(o).copy()),
                       torch.from_numpy(np.asarray(dd).copy()),
                       torch.from_numpy(pix.astype(np.int64)),
                       torch.from_numpy(samp.astype(np.int64)),
                       tcfg).numpy()
    close = np.zeros(n, bool)
    for lane, gap, _ in draws:
        close[lane[gap < 1e-5].numpy()] = True
    n_draws = sum(int(lane.numel()) for lane, _, _ in draws)
    killed = sum(k for _, _, k in draws)
    print(f"roulette draws {n_draws}, lanes killed {killed}, lanes with "
          f"|u - q| < 1e-5: {int(close.sum())} of {n}")
    assert n_draws > 50 and killed > 10, "the roulette must bite"
    print(f"lanes with radiance: {(ref.sum(-1) > 0).mean():.3f}")
    assert (ref.sum(-1) > 0).mean() > 0.2
    ok = ~close
    np.testing.assert_allclose(got[ok], ref[ok], atol=1e-4)


def test_renderer_fast_mc_renders():
    d = golden_dict("spheres_metal_glass")
    ts = tscene.from_dict(d, device="cpu")[0]
    r = trender.Renderer(device="cpu")
    r.set_samples(2)
    r.set_max_depth(20)
    full = r.render_linear(ts, 24, 18)
    r.fast_mc = True
    cfg = r.trace_config()
    assert (cfg.russian_roulette_start, cfg.throughput_epsilon) == (8, 1e-4)
    img = r.render_linear(ts, 24, 18)
    assert img.shape == (18, 24, 3) and np.isfinite(img).all()
    # an unbiased estimator: the frame's mean moves little
    assert abs(float(img.mean()) - float(full.mean())) < 0.05 * float(
        full.mean())
    u8 = r.render(ts, 24, 18)
    assert u8.dtype == np.uint8 and u8.shape == (18, 24, 3)
