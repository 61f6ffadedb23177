"""The speculative capacity path of render_wavefront on the CPU (the
kernels' plain versions), in every kernel mode.

* The fused frame (a later frame of a key, at the cached capacity, with
  or without assume_capacity) equals the first frame of its key at error
  0: the same static capacity, the same chunks, the same sums.
* A scene with more hit pixels at the same key is caught: under
  assume_capacity by flush_capacity_checks, which raises and drops the
  key; without it by the validating path, which renders the frame again
  ("retry") equal to that scene's first frame of the key.
* A forced ladder overflow (SURV_FRAC raised) blacklists the key, in both
  forms, and the key then renders unsplit, equal to the unsplit frame.
* The capacity cache is a FIFO of 64; _pad_bucket pads under an eighth;
  the compaction's padding slots hold a rejected pixel and add nothing;
  the interleaved trace chunks are the boolean form's, by index
  arithmetic.
* ``post`` runs on the image and ``as_numpy`` returns the host array.
* The frame stays within the goldens gate (<= 0.1% of pixels off by
  > 1e-3, mean abs error < 1e-4) of the JAX package's jnp engine
  (raytrace_tpu.renderer.render_band).

Small scenes are forced into stream mode by lowering MAX_BVH_KERNEL_PRIMS
before they are built, as tests/test_torch_split.py does; depth 12 takes
them through the split ladder. No Pallas kernel is called here.
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
from raytrace_tpu_torch.bench.suite import bvh_scene_dict, golden_scene_dict
from raytrace_tpu_torch.ops import megakernel as tmk
from raytrace_tpu_torch.ops import tonemap as ttonemap
from test_torch_renderer import asset_dict, gate
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_split import stream_dict

W, H = 32, 24
MODES = ("unroll", "bvh", "loop", "stream")


def scene_dict(mode):
    if mode == "unroll":
        return asset_dict("sphere_reflections_light")
    if mode == "bvh":
        return bvh_scene_dict("ring100-noground")
    if mode == "loop":
        return golden_scene_dict("mesh_smooth_icosphere")[0]
    return stream_dict()


def mode_scene(mode, monkeypatch):
    """A CPU scene of the kernel mode (stream: forced, leaf size 4)."""
    d = scene_dict(mode)
    if mode == "loop":
        s = tscene.from_dict(d, device="cpu", build_accel=False)[0]
    elif mode == "stream":
        monkeypatch.setattr(tmk, "UNROLL_PRIM_LIMIT", 4)
        monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 8)
        s = tscene.with_accel(tscene.from_dict(d, device="cpu")[0],
                              leaf_size=4)
    else:
        s = tscene.from_dict(d, device="cpu")[0]
    assert tmk._kernel_mode(s) == mode
    return s


def cfg_of(mode):
    # depth 12 is the least at which a stream frame takes the ladder
    return ttrace.TraceConfig(max_depth=12 if mode == "stream" else 4,
                              shadow_samples=2)


def key_of(cfg, post=None, samples=2, width=W, height=H):
    return trender.capacity_key(width, height, samples, cfg, True, post,
                                "cpu")


def first_of_key(scene, cfg, samples=2, **kw):
    """The first frame of its key: one read of the hit count sizes the
    capacity."""
    trender._KPAD_CACHE.pop(key_of(cfg, kw.get("post"), samples), None)
    return trender.render_wavefront(scene, width=W, height=H,
                                    samples=samples, cfg=cfg, **kw)


@pytest.fixture(autouse=True)
def clean_state():
    """Each test starts with no pending flags and leaves no key behind."""
    trender._PENDING_CHECKS.clear()
    yield
    trender._PENDING_CHECKS.clear()
    trender._KPAD_CACHE.clear()


@pytest.mark.parametrize("mode", MODES)
def test_fused_frame_equals_first_frame(mode, monkeypatch):
    s = mode_scene(mode, monkeypatch)
    cfg = cfg_of(mode)
    stages = []
    hook = lambda stage, **v: stages.append(stage)
    ref = first_of_key(s, cfg, hook=hook)
    assert "count" in stages and "check" not in stages
    if mode == "stream":
        assert "split_compact" in stages
    k_pad = trender._KPAD_CACHE[key_of(cfg)]
    stages.clear()
    fused = trender.render_wavefront(s, width=W, height=H, samples=2,
                                     cfg=cfg, assume_capacity=True,
                                     hook=hook)
    assert "count" not in stages and "check" not in stages
    assert len(trender._PENDING_CHECKS) == 1
    assert trender.flush_capacity_checks() == 1
    assert torch.equal(fused, ref)
    stages.clear()
    checked = trender.render_wavefront(s, width=W, height=H, samples=2,
                                       cfg=cfg, hook=hook)
    assert "check" in stages and "retry" not in stages
    assert torch.equal(checked, ref)
    assert trender._KPAD_CACHE[key_of(cfg)] == k_pad


def grown_pair(monkeypatch):
    """The bench scene, and at the same key a scene whose every pixel
    hits (ring-100 with its ground); the capacity's quantum lowered to 32
    pixels, so that the bench scene's is below the frame's."""
    monkeypatch.setattr(trender, "SPLIT_QUANTUM", 64)
    small = tscene.from_dict(asset_dict("sphere_reflections_light"),
                             device="cpu")[0]
    big = tscene.from_dict(bvh_scene_dict("ring100"), device="cpu")[0]
    return small, big


def test_grown_scene_is_caught_by_flush(monkeypatch):
    small, big = grown_pair(monkeypatch)
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=2)
    first_of_key(small, cfg)
    key = key_of(cfg)
    k_small = trender._KPAD_CACHE[key]
    assert k_small < W * H
    trender.render_wavefront(big, width=W, height=H, samples=2, cfg=cfg,
                             assume_capacity=True)
    with pytest.raises(RuntimeError, match="dropped pixels"):
        trender.flush_capacity_checks()
    assert key not in trender._KPAD_CACHE
    assert not trender._PENDING_CHECKS


def test_grown_scene_is_rendered_again_when_validated(monkeypatch):
    small, big = grown_pair(monkeypatch)
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=2)
    want = first_of_key(big, cfg)
    first_of_key(small, cfg)
    k_small = trender._KPAD_CACHE[key_of(cfg)]
    retry = []
    img = trender.render_wavefront(
        big, width=W, height=H, samples=2, cfg=cfg,
        hook=lambda stage, **v: retry.append(v) if stage == "retry"
        else None)
    assert retry and retry[0]["k"] > k_small == retry[0]["k_pad"]
    assert torch.equal(img, want)
    assert trender._KPAD_CACHE[key_of(cfg)] == W * H


@pytest.mark.parametrize("assume", [True, False])
def test_ladder_overflow_blacklists_and_renders_unsplit(assume,
                                                        monkeypatch):
    s = mode_scene("stream", monkeypatch)
    cfg = cfg_of("stream")
    key = key_of(cfg)
    first_of_key(s, cfg)
    trender._SPLIT_BLACKLIST.add(key)
    try:
        unsplit = trender.render_wavefront(s, width=W, height=H, samples=2,
                                           cfg=cfg)
    finally:
        trender._SPLIT_BLACKLIST.discard(key)
    monkeypatch.setattr(trender, "SURV_FRAC", 1 << 30)
    monkeypatch.setattr(trender, "SPLIT_QUANTUM", 1)
    seen = []
    hook = lambda stage, **v: seen.append((stage, v.get("overflow")))
    try:
        img = trender.render_wavefront(s, width=W, height=H, samples=2,
                                       cfg=cfg, assume_capacity=assume,
                                       hook=hook)
        if assume:
            with pytest.raises(RuntimeError, match="overflowed"):
                trender.flush_capacity_checks()
        else:
            assert any(st == "overflow" and ov > 0 for st, ov in seen)
            assert any(st == "retry" for st, _ in seen)
            assert torch.equal(img, unsplit)
        assert key in trender._SPLIT_BLACKLIST
        seen.clear()
        again = trender.render_wavefront(s, width=W, height=H, samples=2,
                                         cfg=cfg, hook=hook)
        assert not any(st in ("split_compact", "overflow")
                       for st, _ in seen)
        assert torch.equal(again, unsplit)
    finally:
        trender._SPLIT_BLACKLIST.discard(key)


def test_capacity_cache_is_a_fifo_of_64():
    s = tscene.from_dict(asset_dict("sphere_reflections_light"),
                         device="cpu")[0]
    trender._KPAD_CACHE.clear()
    keys = [("key", i) for i in range(trender._KPAD_CACHE_MAX + 6)]
    for i, k in enumerate(keys):
        trender._kpad_cache_put(k, i)
    assert len(trender._KPAD_CACHE) == trender._KPAD_CACHE_MAX == 64
    assert list(trender._KPAD_CACHE) == keys[6:]
    trender._kpad_cache_put(keys[10], -1)  # an update keeps its place
    assert list(trender._KPAD_CACHE) == keys[6:]
    cfg = ttrace.TraceConfig(max_depth=1, shadow_samples=1)
    trender.render_wavefront(s, width=8, height=6, samples=1, cfg=cfg)
    assert len(trender._KPAD_CACHE) == 64
    assert keys[6] not in trender._KPAD_CACHE
    assert key_of(cfg, samples=1, width=8, height=6) in trender._KPAD_CACHE


def test_pad_bucket_pads_at_most_an_eighth():
    for q in (1, 3, 20, 512):
        for k in list(range(1, 300)) + [9888, 480000, 1 << 20]:
            b = trender._pad_bucket(k, q)
            assert b >= k and b % q == 0
            blocks = -(-k // q)
            assert b // q - blocks < max(1.0, blocks / 8)


def test_compaction_padding_holds_a_rejected_pixel():
    hit = torch.tensor([0, 1, 1, 0, 1, 0, 0, 1], dtype=torch.bool)
    pos = torch.cumsum(hit.to(torch.int64), 0) - 1
    ids = torch.tensor([1, 2, 4, 7])
    assert torch.equal(trender._compact_pixels(hit, pos, 4), ids)
    assert torch.equal(trender._compact_pixels(hit, pos, 2), ids[:2])
    padded = trender._compact_pixels(hit, pos, 7)
    assert torch.equal(padded[:4], ids)
    assert not hit[padded[4:]].any()


@pytest.mark.parametrize("n", [1, 64, 1000, 4097, 20000])
def test_interleaved_chunks_are_the_boolean_form(n, monkeypatch):
    """The chunks of a split frame by index arithmetic equal the former
    boolean selection (chunk c takes the slots whose run is c modulo the
    chunk count), in the same order."""
    monkeypatch.setattr(trender, "TRACE_LANES", 1 << 12)
    samples = 4
    got = trender._pixel_chunks(n, samples, True, "cpu")
    chunk = trender.TRACE_LANES // samples
    slots = torch.arange(n)
    if n <= chunk:
        want = [slots]
    else:
        per = max(1, chunk // trender.CHUNK_RUN)
        n_chunks = -(-(-(-n // trender.CHUNK_RUN)) // per)
        run = slots // trender.CHUNK_RUN % n_chunks
        want = [slots[run == c] for c in range(n_chunks)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(slots[g], w)
    assert all(slots[g].numel() * samples <= trender.TRACE_LANES
               for g in got)


def test_post_and_as_numpy():
    s = tscene.from_dict(asset_dict("sphere_reflections_light"),
                         device="cpu")[0]
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=2)
    post = ttonemap.tonemap_rgb8
    lin = first_of_key(s, cfg)
    for assume in (False, True, True):
        img = trender.render_wavefront(s, width=W, height=H, samples=2,
                                       cfg=cfg, post=post,
                                       assume_capacity=assume)
        assert img.dtype == torch.uint8 and torch.equal(img, post(lin))
    arr = trender.render_wavefront(s, width=W, height=H, samples=2, cfg=cfg,
                                   post=post, as_numpy=True,
                                   assume_capacity=True)
    assert isinstance(arr, np.ndarray) and np.array_equal(arr,
                                                          post(lin).numpy())
    assert trender.flush_capacity_checks() == 3
    assert isinstance(trender.render_wavefront(
        s, width=W, height=H, samples=2, cfg=cfg, as_numpy=True), np.ndarray)


@pytest.mark.parametrize("mode", ["unroll", "bvh"])
def test_fused_frame_meets_the_jax_engine(mode, monkeypatch):
    s = mode_scene(mode, monkeypatch)
    cfg = cfg_of(mode)
    first_of_key(s, cfg)
    got = trender.render_wavefront(s, width=W, height=H, samples=2, cfg=cfg,
                                   assume_capacity=True)
    assert trender.flush_capacity_checks() == 1
    js = jscene.from_dict(scene_dict(mode))[0]
    jcfg = jtrace.TraceConfig(max_depth=cfg.max_depth,
                              shadow_samples=cfg.shadow_samples)
    want = np.asarray(jrender.render_band(js, jnp.int32(0), width=W,
                                          height=H, band_h=H, samples=2,
                                          cfg=jcfg))
    assert (want.sum(-1) > 0).any()
    gate(got.numpy(), want)
