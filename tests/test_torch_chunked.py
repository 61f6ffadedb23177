"""render_wavefront_chunked and pick_chunk_spp on the CPU: the cases of
tests/test_chunked.py on the port, and the chunked frame against the JAX
package's jnp engine.

* Chunked rounds add up to the one-round frame (the same lanes, one float
  add a round boundary: rtol 2e-6, atol 2e-7); chunk >= samples is the
  one-round frame itself, bit for bit.
* A round's per-pixel sums depend only on its sample ids: computed out of
  order and again they are equal bit for bit, and the chunked frame is
  deterministic.
* The split ladder composes with the rounds: a stream scene forced into
  stream mode at depth 12, split and unsplit, chunked and not, agree
  within 1e-5; pick_chunk_spp gives stream scenes rounds of 10.
* A round whose ladder overflows (a first capacity of one lane)
  blacklists the chunked key and renders the frame again unsplit, equal
  to the unsplit frame within 1e-6; under assume_capacity the frame
  records one deferred flag, which flush_capacity_checks raises on.
* The chunked frame is within the goldens gate of
  raytrace_tpu.renderer.render_band.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu import renderer as jrender
from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.ops import megakernel as tmk
from test_torch_renderer import gate
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_split import stream_dict


def scene_dict():
    """tests/test_chunked.py's scene: a plane and three spheres (metal,
    glass, lambertian)."""
    objs = [{"type": "plane", "position": [0, -1.0, 0],
             "normal": [0, 1, 0],
             "material": {"type": "lambertian", "color": [0.6, 0.6, 0.6]}},
            {"type": "sphere", "position": [0, 0, -3], "radius": 1.0,
             "material": {"type": "metal", "color": [0.8, 0.8, 0.9],
                          "roughness": 0.1}},
            {"type": "sphere", "position": [1.6, -0.4, -2.4],
             "radius": 0.5,
             "material": {"type": "glass", "color": [0.9, 0.9, 0.9]}},
            {"type": "sphere", "position": [-1.6, -0.4, -2.4],
             "radius": 0.5,
             "material": {"type": "lambertian",
                          "color": [0.7, 0.3, 0.3]}}]
    return {"camera": {"position": [0, 0.5, 2], "aspectRatio": 1.33},
            "objects": objs,
            "lights": [{"type": "point", "position": [4, 8, 4],
                        "color": [1, 1, 1], "intensity": 2.0}]}


def scene():
    return tscene.from_dict(scene_dict(), device="cpu")[0]


@pytest.fixture
def stream_scene(monkeypatch):
    monkeypatch.setattr(tmk, "UNROLL_PRIM_LIMIT", 4)
    monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 8)
    s = tscene.with_accel(tscene.from_dict(stream_dict(), device="cpu")[0],
                          leaf_size=4)
    assert tmk._kernel_mode(s) == "stream"
    return s


@pytest.fixture(autouse=True)
def clean_state():
    trender._PENDING_CHECKS.clear()
    yield
    trender._PENDING_CHECKS.clear()
    trender._KPAD_CACHE.clear()


def test_chunked_matches_unchunked():
    s = scene()
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=2)
    kw = dict(width=12, height=8, samples=4, cfg=cfg)
    full = trender.render_wavefront(s, **kw)
    for chunk in (1, 2, 3):
        part = trender.render_wavefront_chunked(s, chunk=chunk, **kw)
        torch.testing.assert_close(part, full, rtol=2e-6, atol=2e-7,
                                   msg=f"chunk={chunk}")
    whole = trender.render_wavefront_chunked(s, chunk=4, **kw)
    assert torch.equal(whole, full)
    assert trender.pick_chunk_spp(s, 100, cfg) == 100


def test_chunked_round_resume_bit_exact():
    s = scene()
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=2)
    hit, pos = trender._pixel_mask(s, width=12, height=8, cfg=cfg,
                                   go_camera=True)
    k = pos[-1] + 1
    px = trender._compact_pixels(hit, pos, trender._pad_bucket(int(k), 1))

    def round_sum(s0, c):
        img, _ = trender._trace_compacted_pixels(
            s, px, k, width=12, height=8, samples=c, cfg=cfg,
            go_camera=True, offset=s0, sum_image=True)
        return img

    r1_first = round_sum(2, 2)
    r0 = round_sum(0, 2)
    r1_again = round_sum(2, 2)
    assert torch.equal(r1_first, r1_again)
    assert not torch.equal(r0, r1_first)
    torch.testing.assert_close((r0 + r1_first) / 4, trender.render_wavefront(
        s, width=12, height=8, samples=4, cfg=cfg), rtol=2e-6, atol=2e-7)
    kw = dict(width=12, height=8, samples=4, cfg=cfg, chunk=2)
    a = trender.render_wavefront_chunked(s, **kw)
    b = trender.render_wavefront_chunked(s, **kw)
    assert torch.equal(a, b)


def test_stream_split_and_chunked_compose(stream_scene):
    cfg = ttrace.TraceConfig(max_depth=12, shadow_samples=1)
    deep = ttrace.TraceConfig(max_depth=16)
    assert trender.pick_split(stream_scene, deep) == (
        (4, 7, 10, 14) if trender.pick_deep_caps(stream_scene) == "const"
        else (2, 5, 8, 11, 14))
    assert trender.pick_split(stream_scene, cfg)
    assert trender.pick_chunk_spp(stream_scene, 100, cfg) == 10
    assert trender.pick_chunk_spp(stream_scene, 4, cfg) == 4
    kw = dict(width=10, height=8, samples=2, cfg=cfg)
    rounds = []
    hook = lambda stage, **v: rounds.append(v["s0"]) if (
        stage == "round") else None
    img_split = trender.render_wavefront(stream_scene, **kw)
    chunk_split = trender.render_wavefront_chunked(stream_scene, chunk=1,
                                                   hook=hook, **kw)
    assert rounds == [0, 1]
    keys = [trender.capacity_key(10, 8, 2, cfg, True, None, "cpu"),
            trender.capacity_key(10, 8, 2, cfg, True, None, "cpu",
                                 "chunked", 1)]
    trender._SPLIT_BLACKLIST.update(keys)
    try:
        img_plain = trender.render_wavefront(stream_scene, **kw)
        chunk_plain = trender.render_wavefront_chunked(stream_scene,
                                                       chunk=1, **kw)
    finally:
        trender._SPLIT_BLACKLIST.difference_update(keys)
    assert img_plain.max() > 0.0
    for img in (img_split, chunk_split, chunk_plain):
        torch.testing.assert_close(img, img_plain, rtol=0, atol=1e-5)


def test_chunked_split_overflow_falls_back(stream_scene, monkeypatch):
    cfg = ttrace.TraceConfig(max_depth=12, shadow_samples=2)
    kw = dict(width=12, height=8, samples=4, cfg=cfg, chunk=2)
    key = trender.capacity_key(12, 8, 4, cfg, True, None, "cpu", "chunked",
                               2)
    trender._SPLIT_BLACKLIST.add(key)
    try:
        ref = trender.render_wavefront_chunked(stream_scene, **kw)
    finally:
        trender._SPLIT_BLACKLIST.discard(key)
    monkeypatch.setattr(trender, "SURV_FRAC", 1 << 30)
    monkeypatch.setattr(trender, "SPLIT_QUANTUM", 1)
    try:
        img = trender.render_wavefront_chunked(stream_scene, **kw)
        assert key in trender._SPLIT_BLACKLIST
        assert img.max() > 0.0
        torch.testing.assert_close(img, ref, rtol=0, atol=1e-6)
        # under assume_capacity the frame records one flag, which the
        # flush raises on
        trender._SPLIT_BLACKLIST.discard(key)
        trender.render_wavefront_chunked(stream_scene, assume_capacity=True,
                                         **kw)
        assert len(trender._PENDING_CHECKS) == 1
        with pytest.raises(RuntimeError, match="overflowed"):
            trender.flush_capacity_checks()
        assert key in trender._SPLIT_BLACKLIST
    finally:
        trender._SPLIT_BLACKLIST.discard(key)


def test_chunked_frame_meets_the_jax_engine():
    s = scene()
    cfg = ttrace.TraceConfig(max_depth=4, shadow_samples=2)
    got = trender.render_wavefront_chunked(s, width=32, height=24,
                                           samples=4, cfg=cfg, chunk=3)
    js = jscene.from_dict(scene_dict())[0]
    want = np.asarray(jrender.render_band(
        js, jnp.int32(0), width=32, height=24, band_h=24, samples=4,
        cfg=jtrace.TraceConfig(max_depth=4, shadow_samples=2)))
    assert (want.sum(-1) > 0).any()
    gate(got.numpy(), want)
