"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips where there is no
GPU. This file imports neither JAX nor the JAX package, so it also runs on
a machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: K2 and K6 must equal their plain version (the same float32
operations, no FMA contraction); K1, K3+K4 and K7, with the extended body
(K1-ext: smooth normals, kinds 7-12, textures), must equal their plain
version under the goldens image gate (<= 0.1% of pixels off by > 1e-3,
mean abs error < 1e-4), which admits the rare lane that a one-ulp
difference of a library pow or sin sends down another branch.
"""

import copy

import json
import os

import pytest
import torch

from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench.suite import (bvh_scene_dict,
                                             golden_scene_dict,
                                             ring_scene_dict)
from raytrace_tpu_torch.ops import megakernel as tmk

# The scenes of the extended body: (asset, kernel); the assets run with
# their own look-at camera.
EXT_ASSETS = (("textured_mirror_demo", "trace_unroll"),
              ("mesh_demo", "trace_unroll"),
              ("smooth_shading_demo", "trace_bvh"))

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
SCENES = ("sphere_reflections_light", "two_red_cubes_scene",
          "final_silver_prism_purple_cube")
BVH_SCENES = ("ring100", "ring1000", "mixed")
# Every pixel of a ring scene passes the mask (the camera sits inside the
# ground's cone-inflated bounding sphere); without the objects that cover
# the whole frame, the mask meets both hits and misses.
MASK_SCENES = BVH_SCENES + ("ring1000-noground", "mixed-noground")


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def scene_dict(name):
    with open(os.path.join(ASSETS, f"{name}.json")) as f:
        d = json.load(f)
    d["camera"]["position"][2] = -d["camera"]["position"][2]
    return d


def scene_on(name, device):
    return tscene.from_dict(scene_dict(name), device=device)[0]


def gate(img, ref):
    diff = (img - ref).abs().amax(dim=-1)
    assert float((diff > 1e-3).float().mean()) <= 1e-3
    assert float((img - ref).abs().mean()) < 1e-4


@pytest.mark.parametrize("name", SCENES)
def test_k2_equals_plain(cuda, name):
    s = scene_on(name, cuda)
    cfg = ttrace.TraceConfig()
    got = tmk.pixel_mask(s, width=200, height=150, cfg=cfg)
    want = tmk.pixel_mask_plain(s, width=200, height=150, cfg=cfg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", SCENES)
def test_k1_matches_plain(cuda, name):
    s = scene_on(name, cuda)
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    W, H, S = 48, 36, 2
    hit, pos = trender._pixel_mask(s, width=W, height=H, cfg=cfg,
                                   go_camera=True)
    px = trender._compact_pixels(hit, pos, int(pos[-1]) + 1)
    pix, samp = trender._lane_ids(px, S)
    o, d = trender._lane_rays(s, pix, samp, width=W, height=H, cfg=cfg,
                              go_camera=True)
    o = o.contiguous()
    got = tmk.trace(s, o, d, pix, samp, cfg)
    want = ttrace.trace(s, o, d, pix, samp, cfg)
    torch.cuda.synchronize()
    img = lambda r: torch.zeros((W * H, 3), device=cuda).index_add_(
        0, px, r.reshape(-1, S, 3).sum(1))
    gate(img(got), img(want))


def lane_image(scene, tracer, cfg, W, H, S, go_camera=True):
    """A (W*H,3) image of the sum of each pixel's S samples traced by
    ``tracer`` over the main path's lanes."""
    hit, pos = trender._pixel_mask(scene, width=W, height=H, cfg=cfg,
                                   go_camera=go_camera)
    px = trender._compact_pixels(hit, pos, int(pos[-1]) + 1)
    pix, samp = trender._lane_ids(px, S)
    o, d = trender._lane_rays(scene, pix, samp, width=W, height=H, cfg=cfg,
                              go_camera=go_camera)
    rad = tracer(scene, o.contiguous(), d, pix, samp, cfg)
    torch.cuda.synchronize()
    return torch.zeros((W * H, 3), device=o.device).index_add_(
        0, px, rad.reshape(-1, S, 3).sum(1))


@pytest.mark.parametrize("name", MASK_SCENES)
def test_k6_equals_plain(cuda, name):
    s = tscene.from_dict(bvh_scene_dict(name), device=cuda)[0]
    assert tmk._kernel_mode(s) == "bvh"
    cfg = ttrace.TraceConfig()
    got = tmk.pixel_mask(s, width=200, height=150, cfg=cfg)
    want = tmk.pixel_mask_plain(s, width=200, height=150, cfg=cfg)
    if name.endswith("-noground"):
        assert want.any() and (~want).any(), "hits and misses expected"
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", BVH_SCENES)
def test_k3_matches_plain(cuda, name):
    s = tscene.from_dict(bvh_scene_dict(name), device=cuda)[0]
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    got = lane_image(s, tmk.trace, cfg, 32, 24, 2)
    gate(got, lane_image(s, ttrace.trace, cfg, 32, 24, 2))


def test_main_path_launches_both_kernels(cuda):
    s = scene_on(SCENES[0], cuda)
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    tmk.reset_launches()
    img = trender.render_wavefront(s, width=160, height=120, samples=4,
                                   cfg=cfg)
    assert tmk.LAUNCHES["trace_unroll"] >= 1
    assert tmk.LAUNCHES["pixel_mask"] >= 1
    dense = trender.render_band(s, 0, width=160, height=120, band_h=120,
                                samples=4, cfg=cfg)
    gate(img, dense)


def test_bvh_main_path_launches_k6_and_k3(cuda):
    s = tscene.from_dict(ring_scene_dict(100), device=cuda)[0]
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    tmk.reset_launches()
    img = trender.render_wavefront(s, width=48, height=36, samples=2,
                                   cfg=cfg)
    assert tmk.LAUNCHES["trace_bvh"] >= 1
    assert tmk.LAUNCHES["pixel_mask_bvh"] >= 1
    assert tmk.LAUNCHES["trace_unroll"] == tmk.LAUNCHES["pixel_mask"] == 0
    dense = trender.render_band(s, 0, width=48, height=36, band_h=36,
                                samples=2, cfg=cfg)
    gate(img, dense)


def icosphere_dict():
    """The mesh_smooth_icosphere golden scene (81 primitives with vertex
    normals)."""
    return golden_scene_dict("mesh_smooth_icosphere")[0]


# Loop-mode scenes: the icosphere without its BVH (81 primitives with
# vertex normals), ring-300 (tables in shared memory) and ring-2500 (past
# K7's shared-memory budget: rows read through __ldg), without a BVH.
LOOP_SCENES = {"icosphere": icosphere_dict, "ring300": lambda: (
    ring_scene_dict(300)), "ring2500": lambda: ring_scene_dict(2500)}


@pytest.mark.parametrize("name", list(LOOP_SCENES))
def test_k7_matches_plain(cuda, name):
    s = tscene.from_dict(LOOP_SCENES[name](), device=cuda,
                         build_accel=False)[0]
    assert tmk._kernel_mode(s) == "loop"
    tabs = tmk.pack_tables(s)
    assert tmk.loop_tables_in_smem(tabs) == (name != "ring2500")
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    W, H, S = (32, 24, 2) if name != "ring2500" else (16, 12, 1)
    tmk.reset_launches()
    got = lane_image(s, tmk.trace, cfg, W, H, S)
    assert tmk.LAUNCHES["trace_loop"] == 1
    gate(got, lane_image(s, ttrace.trace, cfg, W, H, S))


@pytest.mark.parametrize("name,kernel", EXT_ASSETS,
                         ids=[a for a, _ in EXT_ASSETS])
def test_k1ext_matches_plain(cuda, name, kernel):
    s = tscene.load(os.path.join(ASSETS, f"{name}.json"), device=cuda)[0]
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    tmk.reset_launches()
    got = lane_image(s, tmk.trace, cfg, 32, 24, 2, go_camera=False)
    assert tmk.LAUNCHES[kernel] == 1
    gate(got, lane_image(s, ttrace.trace, cfg, 32, 24, 2, go_camera=False))


def with_lights(d, n):
    d = copy.deepcopy(d)
    d["lights"] = [{"position": [4 - 0.4 * i, 6, 5 - 0.3 * i],
                    "color": [1, 1, 1], "intensity": 3.0} for i in range(n)]
    return d


@pytest.mark.parametrize("mode", ["unroll", "bvh", "loop"])
def test_run_time_bounds_match_plain(cuda, mode):
    """max_depth 100, 20 lights and 80 soft-shadow samples (K4 in two
    blocks of samples) on every trace kernel."""
    d = {"unroll": lambda: scene_dict(SCENES[2]),
         "bvh": lambda: bvh_scene_dict("mixed"),
         "loop": icosphere_dict}[mode]()
    s = tscene.from_dict(with_lights(d, 20), device=cuda,
                         build_accel=False if mode == "loop" else None)[0]
    assert tmk._kernel_mode(s) == mode
    cfg = ttrace.TraceConfig(max_depth=100, shadow_samples=80)
    got = lane_image(s, tmk.trace, cfg, 16, 12, 1)
    gate(got, lane_image(s, ttrace.trace, cfg, 16, 12, 1))


def test_loop_main_path_launches_k2_and_k7(cuda):
    s = tscene.from_dict(icosphere_dict(), device=cuda,
                         build_accel=False)[0]
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    tmk.reset_launches()
    img = trender.render_wavefront(s, width=48, height=36, samples=2,
                                   cfg=cfg)
    assert tmk.LAUNCHES["trace_loop"] >= 1
    assert tmk.LAUNCHES["pixel_mask"] >= 1
    assert tmk.LAUNCHES["trace_unroll"] == tmk.LAUNCHES["trace_bvh"] == 0
    dense = trender.render_band(s, 0, width=48, height=36, band_h=36,
                                samples=2, cfg=cfg)
    gate(img, dense)
