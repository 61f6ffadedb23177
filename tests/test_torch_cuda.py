"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips where there is no
GPU. This file imports neither JAX nor the JAX package, so it also runs on
a machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: K2, K6 and K6-stream must equal their plain version (the
same float32 operations, no FMA contraction), also at sizes with partial
tiles and with their table built in shared memory or past the budget (K2
in chunks, K6 and K6-stream read in place), on the camera row that the
kernels build themselves, which must equal _mask_camera's row computed
by PyTorch on the card bit for bit, and their pre-pass must write the
plain version's table bit for bit; a mask launch must build nothing on
the host; K1, K3+K4, K5 and K7, with
the extended body (K1-ext: smooth normals, kinds 7-12, textures), must
equal their plain version under the goldens image gate (<= 0.1% of pixels
off by > 1e-3, mean abs error < 1e-4), which admits the rare lane that a
one-ulp difference of a library pow or sin sends down another branch. K5
must equal K3+K4 on the same tree bit for bit, work counters too (the
same walks over the same floats), and its plain version, on leaves of 32
and 128 rows, on partial warps and at depth 100 with 20 lights and 80
soft rays. P1's three variants must equal the plain chain bit for bit.
K3+K4 over its walk table must equal the plain version bit for bit, and
the same launch with the table read in place (past a lowered budget),
work counters too, on partial warps, from resumed state and at depth 100
with 20 lights and 80 soft rays. K1 and K7 (persistent blocks, K1-guard
in both, in chunks of 96 occluders past 96) must equal the plain guarded
version bit for bit and themselves unguarded, on ring-2500 with its
tables in shared memory, on partial warps and dead lanes, at depth 100,
on the twin scene's ties and in the K1-state entries; K7's work counters
must equal K1's on the same scene. K3-wide (the 4-wide walk of K3+K4 and
K5) must take its plain version's hits where primitives tie exactly in
t. K1-state's two segments must give the alive flags of the plain
version exactly, its state on the lanes still alive, and the unsplit
launch's radiance under the image gate. A scene past the JAX package's
262,144-primitive cap renders through K6-stream and K5. The
differentiable path (no kernel: autograd through the eager engine) gives
on the card the CPU's image within 1e-5 and its gradients within rtol
1e-4, atol 1e-6, and its keep_accel form equals brute force.
"""

import copy
import dataclasses
import json
import os

import pytest
import torch

from raytrace_tpu_torch import bvh as tbvh
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench.suite import (bvh_scene_dict,
                                             golden_scene_dict,
                                             grid_scene_dict,
                                             ring_scene_dict,
                                             twin_scene_dict)
from raytrace_tpu_torch.bench.suite import mesh_scene_dict as suite_mesh
from raytrace_tpu_torch.ops import megakernel as tmk
from raytrace_tpu_torch.ops import shade as tshade
from raytrace_tpu_torch.tools import measure_dma_stream as p1

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


def test_k3_wide_tie_order_matches_plain(cuda):
    """K3-wide on twin_scene_dict (exact ties): the kernel's 4-wide walk
    takes the copies of its plain version; without the 4-wide view the
    binary walk takes other copies on some lanes, as its plain version
    does."""
    s = tscene.with_accel(tscene.from_dict(twin_scene_dict(),
                                           device=cuda)[0], leaf_size=1)
    assert tbvh.wide_walk(s.accel)
    binary = dataclasses.replace(s, accel=dataclasses.replace(
        s.accel, wide4=None))
    cfg = ttrace.TraceConfig(max_depth=4, shadow_samples=4)
    lanes = main_path_lanes(s, 32, 24, 2, cfg)
    wide = tmk.trace(s, *lanes, cfg)
    gate(wide, ttrace.trace(s, *lanes, cfg))
    walk2 = tmk.trace(binary, *lanes, cfg)
    gate(walk2, ttrace.trace(binary, *lanes, cfg))
    assert int(((wide - walk2).abs().amax(-1) > 1e-3).sum()) >= 5


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
# vertex normals), ring-300 and ring-2500 (51 KB of tables: past 48 KB,
# the launch opts in), without a BVH, all with their tables in shared
# memory; "ring2500-ldg" lowers the budget, so the rows are read through
# __ldg.
LOOP_SCENES = {"icosphere": icosphere_dict, "ring300": lambda: (
    ring_scene_dict(300)), "ring2500": lambda: ring_scene_dict(2500),
    "ring2500-ldg": lambda: ring_scene_dict(2500)}


@pytest.mark.parametrize("name", list(LOOP_SCENES))
def test_k7_matches_plain(cuda, name, monkeypatch):
    s = tscene.from_dict(LOOP_SCENES[name](), device=cuda,
                         build_accel=False)[0]
    assert tmk._kernel_mode(s) == "loop"
    ldg = name.endswith("-ldg")
    if ldg:
        monkeypatch.setattr(tmk, "LOOP_SMEM_BYTES", 48 * 1024)
    tabs = tmk.pack_tables(s)
    assert tmk.loop_tables_in_smem(tabs) == (not ldg)
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    W, H, S = (16, 12, 1) if name.startswith("ring2500") else (32, 24, 2)
    tmk.reset_launches()
    got = lane_image(s, tmk.trace, cfg, W, H, S)
    assert tmk.LAUNCHES["trace_loop"] == tmk.LAUNCHES["trace_guard"] == 1
    assert tmk.LAUNCHES["trace_loop_ldg"] == int(ldg)
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


def forced_stream(d, device, monkeypatch, leaf_size=4):
    """A small scene in stream mode (MAX_BVH_KERNEL_PRIMS patched below
    its size before it is built, so its accel carries the stream table),
    on a tree of leaf_size (4 unless asked)."""
    monkeypatch.setattr(tmk, "UNROLL_PRIM_LIMIT", 4)
    monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 8)
    s = tscene.with_accel(tscene.from_dict(d, device=device,
                                           build_accel=False)[0],
                          leaf_size=leaf_size)
    assert tmk._kernel_mode(s) == "stream"
    assert s.accel.stream_tab is not None
    return s


def main_path_lanes(scene, W, H, S, cfg):
    hit, pos = trender._pixel_mask(scene, width=W, height=H, cfg=cfg,
                                   go_camera=True)
    px = trender._compact_pixels(hit, pos, int(pos[-1]) + 1)
    pix, samp = trender._lane_ids(px, S)
    o, d = trender._lane_rays(scene, pix, samp, width=W, height=H, cfg=cfg,
                              go_camera=True)
    return o.contiguous(), d, pix, samp


@pytest.mark.parametrize("name", ["ring100", "mixed"])
def test_k5_equals_k3_and_plain(cuda, name, monkeypatch):
    s = forced_stream(bvh_scene_dict(name), cuda, monkeypatch)
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    lanes = main_path_lanes(s, 32, 24, 2, cfg)
    tmk.reset_launches()
    k5 = tmk.trace(s, *lanes, cfg)
    assert tmk.LAUNCHES["trace_stream"] == 1
    gate(k5, ttrace.trace(s, *lanes, cfg))
    monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 4096)
    tree = dataclasses.replace(s, accel=dataclasses.replace(
        s.accel, stream_tab=None))
    assert tmk._kernel_mode(tree) == "bvh"
    assert torch.equal(k5, tmk.trace(tree, *lanes, cfg))


@pytest.mark.parametrize("name", ["ring100-noground", "mixed-noground"])
def test_k6_stream_equals_plain(cuda, name, monkeypatch):
    s = forced_stream(bvh_scene_dict(name), cuda, monkeypatch)
    cfg = ttrace.TraceConfig()
    tmk.reset_launches()
    got = tmk.pixel_mask(s, width=200, height=150, cfg=cfg)
    assert tmk.LAUNCHES["pixel_mask_stream"] == 1
    want = tmk.pixel_mask_plain(s, width=200, height=150, cfg=cfg)
    assert want.any() and (~want).any(), "hits and misses expected"
    assert torch.equal(got, want)
    monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 4096)
    k6 = tmk.pixel_mask(s, width=200, height=150, cfg=cfg)
    assert not (k6 & ~got).any()  # node-only passes a superset of K6


STATE_SCENES = {"unroll": lambda: scene_dict(SCENES[2]),
                "bvh": lambda: bvh_scene_dict("mixed"),
                "stream": lambda: bvh_scene_dict("mixed"),
                "loop": icosphere_dict}


@pytest.mark.parametrize("mode", list(STATE_SCENES))
def test_k1_state_matches_unsplit(cuda, mode, monkeypatch):
    d = STATE_SCENES[mode]()
    if mode == "stream":
        s = forced_stream(d, cuda, monkeypatch)
    else:
        s = tscene.from_dict(d, device=cuda,
                             build_accel=False if mode == "loop" else None)[0]
    assert tmk._kernel_mode(s) == mode
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    lanes = main_path_lanes(s, 32, 24, 2, cfg)
    whole = tmk.trace(s, *lanes, cfg)
    tmk.reset_launches()
    ra, st = tmk.trace(s, *lanes, cfg, end_bounce=3, return_state=True)
    rb = tmk.trace(s, st["origin"], st["direction"], *lanes[2:], cfg,
                   start_bounce=3, init_throughput=st["throughput"],
                   init_alive=st["alive"])
    assert tmk.LAUNCHES["trace_state"] == 2
    pa, pst = ttrace.trace(s, *lanes, cfg, end_bounce=3, return_state=True)
    assert torch.equal(st["alive"], pst["alive"])
    alive = pst["alive"] > 0
    for k in ("origin", "direction", "throughput"):
        assert torch.equal(st[k][alive], pst[k][alive]), k
    gate(ra + rb, whole)


def test_stream_main_path_launches_k6s_k5_and_state(cuda, monkeypatch):
    s = forced_stream(bvh_scene_dict("mixed"), cuda, monkeypatch)
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    assert trender.pick_split(s, cfg) == (4, 7, 10, 14, 20, 29, 42)
    tmk.reset_launches()
    img = trender.render_wavefront(s, width=48, height=36, samples=2,
                                   cfg=cfg)
    assert tmk.LAUNCHES["pixel_mask_stream"] == 1
    assert tmk.LAUNCHES["trace_stream"] == tmk.LAUNCHES["trace_state"] == 8
    assert tmk.LAUNCHES["trace_bvh"] == tmk.LAUNCHES["pixel_mask_bvh"] == 0
    dense = trender.render_band(s, 0, width=48, height=36, band_h=36,
                                samples=2, cfg=cfg)
    gate(img, dense)


GUARD_SCENES = {"bench": lambda: scene_dict(SCENES[0]),
                "spheres": lambda: golden_scene_dict("spheres_metal_glass")[0],
                "cubes": lambda: golden_scene_dict(
                    "cubes_dielectric_plane")[0],
                "prism": lambda: golden_scene_dict("prism_perfectmirror")[0]}


@pytest.mark.parametrize("name", list(GUARD_SCENES))
def test_k1_guard_equals_unguarded(cuda, name):
    """K1-guard skips occluders that cannot block: K1 with the guard
    equals K1 without it bit for bit, on both entries, and skips some
    (lane, light, occluder) triples."""
    s = tscene.from_dict(GUARD_SCENES[name](), device=cuda)[0]
    assert tmk._kernel_mode(s) == "unroll"
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    lanes = main_path_lanes(s, 48, 36, 2, cfg)
    outs = {}
    for guard in (True, False):
        cnt = torch.zeros((lanes[0].shape[0], tmk.COUNTERS),
                          dtype=torch.int32, device=cuda)
        out, launch = tmk.prepare_trace(s, *lanes, cfg, soft_guard=guard,
                                        counters=cnt)
        launch()
        st_out, st_launch = tmk.prepare_trace(
            s, *lanes, cfg, soft_guard=guard, end_bounce=3,
            return_state=True)
        st_launch()
        outs[guard] = (out, st_out, cnt.sum(0))
    assert torch.equal(outs[True][0], outs[False][0])
    for k in ("origin", "direction", "throughput", "alive"):
        assert torch.equal(outs[True][1][1][k], outs[False][1][1][k])
    assert torch.equal(outs[True][1][0], outs[False][1][0])
    c = outs[True][2]
    assert int(c[5]) > 0 and int(c[6]) < int(c[5])  # guards, flagged
    assert int(outs[False][2][5]) == 0


def plain_guarded(s, lanes, cfg, monkeypatch, **kw):
    """The plain guarded version: the plain engine with K1-guard's soft
    loop (megakernel.shadow_factor_guarded)."""
    with monkeypatch.context() as m:
        m.setattr(tshade, "shadow_factor", tmk.shadow_factor_guarded)
        return ttrace.trace(s, *lanes, cfg, **kw)


def brute_both(s, lanes, cfg, **kw):
    """K1 or K7 with K1-guard and without it on the same lanes: (output,
    work counters) of each."""
    out = []
    for guard in (True, False):
        cnt = torch.zeros((lanes[0].shape[0], tmk.COUNTERS),
                          dtype=torch.int32, device=lanes[0].device)
        rad, launch = tmk.prepare_trace(s, *lanes, cfg, counters=cnt,
                                        soft_guard=guard, **kw)
        launch()
        out.append((rad, cnt))
    return out


def twins_without_plane():
    """The twin scene's 96 spheres alone: K1's size, exact ties in t."""
    d = twin_scene_dict()
    d["objects"] = [o for o in d["objects"] if o["type"] != "plane"]
    return d


def twin_brute(device, monkeypatch, kernel):
    """The twin scene without a BVH (exact ties in t): K7's with its 97
    primitives (two chunks of K1-guard), K1's without its plane (96)."""
    d = twin_scene_dict() if kernel == "trace_loop" else twins_without_plane()
    return tscene.from_dict(d, device=device, build_accel=False)[0]


# (kernel, scene, depth, lights, soft rays, frame): the bench scene; the
# twin scene's ties (96 occluders for K1; 97 for K7, two chunks of
# K1-guard); ring-2500
# (2,501 occluders, its 51 KB of tables in shared memory); the mixed scene
# without its BVH (102 occluders, a chunk that crosses the kinds); depth
# 100 with 20 lights and 80 soft rays (two blocks of rays)
BRUTE_CASES = {
    "k1-bench": ("trace_unroll", lambda d, m: scene_on(SCENES[0], d),
                 50, 16, (48, 36, 2)),
    "k1-twins": ("trace_unroll", lambda d, m: twin_brute(d, m,
                                                         "trace_unroll"),
                 8, 16, (32, 24, 2)),
    "k1-depth100": ("trace_unroll", lambda d, m: tscene.from_dict(
        with_lights(scene_dict(SCENES[2]), 20), device=d)[0], 100, 80,
        (16, 12, 1)),
    "k7-twins": ("trace_loop", lambda d, m: twin_brute(d, m, "trace_loop"),
                 8, 16, (32, 24, 2)),
    "k7-ring2500": ("trace_loop", lambda d, m: tscene.from_dict(
        ring_scene_dict(2500), device=d, build_accel=False)[0], 50, 16,
        (16, 12, 2)),
    "k7-mixed": ("trace_loop", lambda d, m: tscene.from_dict(
        bvh_scene_dict("mixed"), device=d, build_accel=False)[0], 50, 16,
        (32, 24, 2)),
    "k7-depth100": ("trace_loop", lambda d, m: tscene.from_dict(
        with_lights(bvh_scene_dict("mixed"), 20), device=d,
        build_accel=False)[0], 100, 80, (16, 12, 1)),
}


@pytest.mark.parametrize("case", list(BRUTE_CASES))
def test_brute_kernels_equal_plain_guarded(cuda, case, monkeypatch):
    """K1 and K7 in their persistent blocks, with K1-guard (in chunks of
    96 occluders past 96): equal bit for bit to themselves unguarded and
    to the plain guarded version, on every lane of a frame, on 1001 lanes
    (not a multiple of 32) as a K1-state segment, and on a segment resumed
    from it with every other lane dead; the guard skips some (lane, light,
    occluder) triples and leaves the ray counts as they are."""
    kernel, make, depth, soft, (W, H, S) = BRUTE_CASES[case]
    s = make(cuda, monkeypatch)
    assert tmk._kernel_mode(s) == kernel.split("_")[1]
    assert tmk.trace_smem_bytes(s) > 0   # the tables in shared memory
    cfg = ttrace.TraceConfig(max_depth=depth, shadow_samples=soft)
    lanes = main_path_lanes(s, W, H, S, cfg)
    tmk.reset_launches()
    (g, cg), (u, cu) = brute_both(s, lanes, cfg)
    assert tmk.LAUNCHES[kernel] == 2 and tmk.LAUNCHES["trace_guard"] == 1
    assert tmk.LAUNCHES["trace_loop_ldg"] == 0
    assert torch.equal(g, u)
    assert torch.equal(g, plain_guarded(s, lanes, cfg, monkeypatch))
    assert torch.equal(cg[:, :3], cu[:, :3])
    work = cg.sum(0)
    assert int(work[5]) > 0 and int(work[6]) < int(work[5])
    assert not cu[:, 5:].any()
    part = tuple(t[:1001] for t in lanes)
    (a, _), (b, _) = brute_both(s, part, cfg, end_bounce=2,
                                return_state=True)
    assert same_out(a, b)
    assert same_as_plain(a, plain_guarded(s, part, cfg, monkeypatch,
                                          end_bounce=2, return_state=True))
    alive = a[1]["alive"].clone()
    alive[::2] = 0.0
    seg = (a[1]["origin"], a[1]["direction"]) + part[2:]
    kw = dict(start_bounce=2, init_throughput=a[1]["throughput"],
              init_alive=alive)
    (c, _), (d, _) = brute_both(s, seg, cfg, **kw)
    assert torch.equal(c, d) and not c[::2].any()
    assert torch.equal(c, plain_guarded(s, seg, cfg, monkeypatch, **kw))


def test_k7_counters_equal_k1(cuda, monkeypatch):
    """K7 and K1 run one policy: on the twin scene's 96 spheres (exact
    ties; forced into loop mode by a lowered unroll limit) K7 - with its
    tables in shared memory and read in place - gives K1's radiance and
    K1's work counters, all eight, lane for lane."""
    s = tscene.from_dict(twins_without_plane(), device=cuda,
                         build_accel=False)[0]
    assert tmk._kernel_mode(s) == "unroll"
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    lanes = main_path_lanes(s, 32, 24, 2, cfg)
    outs = []
    for budget in (tmk.LOOP_SMEM_BYTES, 0):
        with monkeypatch.context() as m:
            m.setattr(tmk, "UNROLL_PRIM_LIMIT", 95)
            m.setattr(tmk, "LOOP_SMEM_BYTES", budget)
            assert tmk._kernel_mode(s) == "loop"
            outs.append(brute_both(s, lanes, cfg)[0])
    tmk.reset_launches()
    outs.append(brute_both(s, lanes, cfg)[0])
    assert tmk.LAUNCHES["trace_unroll"] == 2
    for rad, cnt in outs[:2]:
        assert torch.equal(rad, outs[2][0]) and torch.equal(cnt, outs[2][1])
    assert int(outs[2][1][:, 5].sum()) > 0


def test_past_cap_scene_renders_through_k6s_and_k5(cuda):
    """A grid of 65^3 spheres over a plane (274,626 primitives, past the
    JAX package's 262,144-primitive cap, where its Renderer leaves its
    kernels) renders at 32x24, 1 spp, depth 2 through K6-stream and K5,
    and K5 equals its plain version on a strided subset of the frame's
    lanes."""
    s = tscene.from_dict(grid_scene_dict(65), device=cuda)[0]
    assert s.prim_count > tmk.MAX_STREAM_KERNEL_PRIMS
    assert not tmk.scene_fits_kernel(s)
    assert tmk.require_mode(s) == "stream"
    cfg = ttrace.TraceConfig(max_depth=2, shadow_samples=16)
    seen = []

    def hook(stage, **v):
        if stage == "lane_rays":
            seen.append({k: v[k] for k in ("origin", "direction", "pix",
                                           "samp")})
        elif stage == "trace":
            seen[-1]["rad"] = v["rad"]

    tmk.reset_launches()
    img = trender.render_wavefront(s, width=32, height=24, samples=1,
                                   cfg=cfg, hook=hook)
    assert tmk.LAUNCHES["pixel_mask_stream"] == 1
    assert tmk.LAUNCHES["trace_stream"] == len(seen) >= 1
    assert tmk.LAUNCHES["trace_bvh"] == tmk.LAUNCHES["pixel_mask_bvh"] == 0
    assert bool(torch.isfinite(img).all()) and bool((img.sum(-1) > 0).any())
    lanes = tuple(torch.cat([c[k] for c in seen])
                  for k in ("origin", "direction", "pix", "samp"))
    got = torch.cat([c["rad"] for c in seen])
    idx = torch.arange(0, got.shape[0], max(1, got.shape[0] // 256),
                       device=cuda)
    want = ttrace.trace(s, *(t[idx] for t in lanes), cfg)
    assert torch.equal(got[idx], want)
    r = trender.Renderer(device=cuda)
    r.set_samples(1)
    r.set_max_depth(2)
    assert r.render(s, 32, 24).shape == (24, 32, 3)


DOF_CASES = (("unroll", lambda: scene_dict(SCENES[0])),
             ("bvh", lambda: bvh_scene_dict("mixed-noground")),
             ("stream", lambda: bvh_scene_dict("mixed-noground")))


@pytest.mark.parametrize("mode,make", DOF_CASES, ids=[c[0] for c in DOF_CASES])
def test_dof_masks_equal_plain(cuda, mode, make, monkeypatch):
    """K2, K6 and K6-stream with thin-lens depth of field equal their plain
    version."""
    if mode == "stream":
        s = forced_stream(make(), cuda, monkeypatch)
    else:
        s = tscene.from_dict(make(), device=cuda)[0]
    assert tmk._kernel_mode(s) == mode
    for L, F in ((0.1, 10.0), (0.25, 5.0)):
        cfg = ttrace.TraceConfig(depth_of_field=True, dof_lens_radius=L,
                                 dof_focus_distance=F)
        got = tmk.pixel_mask(s, width=200, height=150, cfg=cfg)
        want = tmk.pixel_mask_plain(s, width=200, height=150, cfg=cfg)
        assert want.any() and (~want).any()
        assert torch.equal(got, want)


FAST_MC_SCENES = {"unroll": lambda: golden_scene_dict(
                      "spheres_metal_glass")[0],
                  "bvh": lambda: bvh_scene_dict("mixed"),
                  "stream": lambda: bvh_scene_dict("mixed"),
                  "loop": icosphere_dict}


@pytest.mark.parametrize("mode", list(FAST_MC_SCENES))
def test_fast_mc_equals_plain(cuda, mode, monkeypatch):
    """Russian roulette and the throughput cutoff in the shared bounce
    body: each trace kernel equals its plain version lane for lane."""
    d = FAST_MC_SCENES[mode]()
    if mode == "stream":
        s = forced_stream(d, cuda, monkeypatch)
    else:
        s = tscene.from_dict(d, device=cuda,
                             build_accel=False if mode == "loop" else None)[0]
    assert tmk._kernel_mode(s) == mode
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16,
                             russian_roulette_start=2,
                             throughput_epsilon=1e-4)
    lanes = main_path_lanes(s, 32, 24, 2, cfg)
    got = tmk.trace(s, *lanes, cfg)
    want = ttrace.trace(s, *lanes, cfg)
    assert float((got - want).abs().max()) == 0.0


@pytest.mark.parametrize("variant", p1.VARIANTS)
@pytest.mark.parametrize("rows,floats", [(8192, 128), (1024, 32 * 23)])
def test_dma_probe_equals_plain(cuda, variant, rows, floats):
    """P1: every variant returns the plain chain's acc bit for bit."""
    tab = p1.make_table(rows, floats).to(cuda)
    p1.reset_launches()
    got = p1.chain(tab, 300, seed=5, variant=variant)
    assert p1.LAUNCHES[variant] == 1
    assert torch.equal(got, p1.chain_plain(tab, 300, seed=5))


def same_tree(s, monkeypatch):
    """The stream scene s as a bvh-mode scene over the same tree (its
    stream table dropped, MAX_BVH_KERNEL_PRIMS raised past it), walked in
    the same order: K3+K4 over it must equal K5."""
    monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 1 << 20)
    accel = dataclasses.replace(s.accel, stream_tab=None)
    if not tbvh.wide_walk(s.accel):
        accel = dataclasses.replace(accel, wide4=None)
    tree = dataclasses.replace(s, accel=accel)
    assert tmk._kernel_mode(tree) == "bvh"
    return tree


def k5_both(s, lanes, cfg, monkeypatch, **kw):
    """K5 and K3+K4 on the same tree, on the same lanes: (radiance, work
    counters) of each."""
    out = []
    with monkeypatch.context() as m:
        for scene in (s, same_tree(s, m)):
            cnt = torch.zeros((lanes[0].shape[0], tmk.BVH_COUNTERS),
                              dtype=torch.int32, device=lanes[0].device)
            rad, launch = tmk.prepare_trace(scene, *lanes, cfg, counters=cnt,
                                            **kw)
            launch()
            out.append((rad, cnt))
    return out


@pytest.mark.parametrize("leaf", [32, 128])
def test_k5_group_walk_equals_k3_and_plain(cuda, leaf, monkeypatch):
    """K5's group leaf tests on leaves of 32 rows (one a thread) and 128
    (four rows a thread in a full group): equal to K3+K4 on the same tree
    (work counters too) and to the plain version bit for bit."""
    s = forced_stream(bvh_scene_dict("mixed"), cuda, monkeypatch,
                      leaf_size=leaf)
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    lanes = main_path_lanes(s, 32, 24, 2, cfg)
    (k5, cnt), (k3, cnt_k3) = k5_both(s, lanes, cfg, monkeypatch)
    assert torch.equal(k5, k3)
    assert torch.equal(cnt, cnt_k3)
    assert torch.equal(k5, ttrace.trace(s, *lanes, cfg))


def test_k5_partial_warps(cuda, monkeypatch):
    """Groups of every size: a lane count that is not a multiple of 32,
    and a resumed segment with every other lane dead; against K3+K4 on
    the same tree (work counters too) and the plain version."""
    s = forced_stream(bvh_scene_dict("mixed"), cuda, monkeypatch,
                      leaf_size=32)
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    lanes = tuple(t[:1001] for t in main_path_lanes(s, 32, 24, 2, cfg))
    (k5, cnt), (k3, cnt_k3) = k5_both(s, lanes, cfg, monkeypatch)
    assert torch.equal(k5, k3) and torch.equal(cnt, cnt_k3)
    assert torch.equal(k5, ttrace.trace(s, *lanes, cfg))
    _, st = tmk.trace(s, *lanes, cfg, end_bounce=2, return_state=True)
    alive = st["alive"].clone()
    alive[::2] = 0.0
    seg = (st["origin"], st["direction"]) + lanes[2:]
    kw = dict(start_bounce=2, init_throughput=st["throughput"],
              init_alive=alive)
    (k5, cnt), (k3, cnt_k3) = k5_both(s, seg, cfg, monkeypatch, **kw)
    assert torch.equal(k5, k3) and torch.equal(cnt, cnt_k3)
    assert not k5[::2].any()
    assert torch.equal(k5, ttrace.trace(s, *seg, cfg, **kw))


def test_k5_run_time_bounds_match_plain(cuda, monkeypatch):
    """max_depth 100, 20 lights and 80 soft-shadow rays on K5 (its soft
    walk in two blocks of rays, 64 and 16): equal to K3+K4 on the same
    tree (work counters too) and to the plain version."""
    s = forced_stream(with_lights(bvh_scene_dict("mixed"), 20), cuda,
                      monkeypatch, leaf_size=32)
    cfg = ttrace.TraceConfig(max_depth=100, shadow_samples=80)
    lanes = main_path_lanes(s, 16, 12, 1, cfg)
    (k5, cnt), (k3, cnt_k3) = k5_both(s, lanes, cfg, monkeypatch)
    assert torch.equal(k5, k3) and torch.equal(cnt, cnt_k3)
    assert torch.equal(k5, ttrace.trace(s, *lanes, cfg))


def k3_both(s, lanes, cfg, **kw):
    """K3+K4 over its walk table as the main path takes it and read in
    place (BVH_SMEM_BYTES lowered to 0) on the same lanes: (output, work
    counters) of each."""
    out = []
    for budget in (tmk.BVH_SMEM_BYTES, 0):
        cnt = torch.zeros((lanes[0].shape[0], tmk.BVH_COUNTERS),
                          dtype=torch.int32, device=lanes[0].device)
        old, tmk.BVH_SMEM_BYTES = tmk.BVH_SMEM_BYTES, budget
        try:
            rad, launch = tmk.prepare_trace(s, *lanes, cfg, counters=cnt,
                                            **kw)
        finally:
            tmk.BVH_SMEM_BYTES = old
        launch()
        out.append((rad, cnt))
    return out


def same_as_plain(got, want):
    """A trace output (radiance, or radiance and state) equal to the
    plain version's: radiance and alive flags bit for bit, and the state
    of the lanes still alive."""
    if not isinstance(got, tuple):
        return torch.equal(got, want)
    alive = want[1]["alive"] > 0
    return (torch.equal(got[0], want[0])
            and torch.equal(got[1]["alive"], want[1]["alive"])
            and all(torch.equal(got[1][k][alive], want[1][k][alive])
                    for k in ("origin", "direction", "throughput")))


def same_out(a, b):
    if isinstance(a, tuple):
        return torch.equal(a[0], b[0]) and all(
            torch.equal(a[1][k], b[1][k]) for k in a[1])
    return torch.equal(a, b)


def ico2561_dict(tmp_path):
    """Two smooth icospheres of 1,280 triangles over a plane: 2,561
    primitives, a walk table of about 135 KB."""
    return suite_mesh(str(tmp_path), subdiv=3)


K3_WALK_CASES = ("ring1000", "mixed", "smooth", "ico2561", "mixed-ldg")


@pytest.mark.parametrize("case", K3_WALK_CASES)
def test_k3_walk_table_equals_global_and_plain(cuda, case, tmp_path,
                                               monkeypatch):
    """K3+K4 over its walk table: equal to the plain version bit for bit,
    and to the same launch with the table read in place (radiance and
    work counters); "mixed-ldg" lowers the budget so the main path's
    launch reads it in place too."""
    go = case != "smooth"
    if case == "smooth":
        s = tscene.load(os.path.join(ASSETS, "smooth_shading_demo.json"),
                        device=cuda)[0]
    elif case == "ico2561":
        s = tscene.from_dict(ico2561_dict(tmp_path), device=cuda)[0]
    else:
        s = tscene.from_dict(bvh_scene_dict(case.split("-")[0]),
                             device=cuda)[0]
    assert tmk._kernel_mode(s) == "bvh"
    walk = tmk.pack_walk_table(s)
    if case == "ico2561":
        assert 120_000 < 4 * walk.numel() <= tmk.BVH_SMEM_BYTES
    if case.endswith("-ldg"):
        monkeypatch.setattr(tmk, "BVH_SMEM_BYTES", 4 * walk.numel() - 16)
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    W, H, S = (16, 12, 2) if case == "ico2561" else (32, 24, 2)
    hit, pos = trender._pixel_mask(s, width=W, height=H, cfg=cfg,
                                   go_camera=go)
    px = trender._compact_pixels(hit, pos, int(pos[-1]) + 1)
    pix, samp = trender._lane_ids(px, S)
    o, d = trender._lane_rays(s, pix, samp, width=W, height=H, cfg=cfg,
                              go_camera=go)
    lanes = (o.contiguous(), d, pix, samp)
    tmk.reset_launches()
    (k3, cnt), (ldg, cnt_ldg) = k3_both(s, lanes, cfg)
    assert tmk.LAUNCHES["trace_bvh"] == 2
    assert tmk.LAUNCHES["trace_bvh_ldg"] == 1 + int(case.endswith("-ldg"))
    assert torch.equal(k3, ldg) and torch.equal(cnt, cnt_ldg)
    assert torch.equal(k3, ttrace.trace(s, *lanes, cfg))


def test_k3_walk_table_partial_warps_and_state(cuda):
    """A lane count that is not a multiple of 32, a segment with state
    out, and a resumed segment with every other lane dead: equal to the
    plain version bit for bit, and to the same launches reading the table
    in place (work counters too)."""
    s = tscene.from_dict(bvh_scene_dict("mixed"), device=cuda)[0]
    cfg = ttrace.TraceConfig(max_depth=50, shadow_samples=16)
    lanes = tuple(t[:1001] for t in main_path_lanes(s, 32, 24, 2, cfg))
    (k3, cnt), (ldg, cnt_ldg) = k3_both(s, lanes, cfg)
    assert torch.equal(k3, ldg) and torch.equal(cnt, cnt_ldg)
    assert torch.equal(k3, ttrace.trace(s, *lanes, cfg))
    (a, cnt), (b, cnt_ldg) = k3_both(s, lanes, cfg, end_bounce=2,
                                     return_state=True)
    assert same_out(a, b) and torch.equal(cnt, cnt_ldg)
    assert same_as_plain(a, ttrace.trace(s, *lanes, cfg, end_bounce=2,
                                         return_state=True))
    st = a[1]
    alive = st["alive"].clone()
    alive[::2] = 0.0
    seg = (st["origin"], st["direction"]) + lanes[2:]
    kw = dict(start_bounce=2, init_throughput=st["throughput"],
              init_alive=alive)
    tmk.reset_launches()
    (k3, cnt), (ldg, cnt_ldg) = k3_both(s, seg, cfg, **kw)
    assert tmk.LAUNCHES["trace_state"] == 2
    assert torch.equal(k3, ldg) and torch.equal(cnt, cnt_ldg)
    assert not k3[::2].any()
    assert torch.equal(k3, ttrace.trace(s, *seg, cfg, **kw))


def test_k3_walk_table_run_time_bounds(cuda):
    """max_depth 100, 20 lights and 80 soft-shadow rays (the fused walk in
    blocks of 64 and 16 rays): equal to the plain version bit for bit, and
    to the same launch reading the table in place, work counters too."""
    s = tscene.from_dict(with_lights(bvh_scene_dict("mixed"), 20),
                         device=cuda)[0]
    cfg = ttrace.TraceConfig(max_depth=100, shadow_samples=80)
    lanes = main_path_lanes(s, 16, 12, 1, cfg)
    (k3, cnt), (ldg, cnt_ldg) = k3_both(s, lanes, cfg)
    assert torch.equal(k3, ldg) and torch.equal(cnt, cnt_ldg)
    assert torch.equal(k3, ttrace.trace(s, *lanes, cfg))


# K6 and K6-stream: the pre-pass and the walk over the mask table. Scenes
# with hits and misses: the mixed scene without its ground and back wall
# in bvh mode and forced into stream mode; ico-2561 (triangles only).
MASK_MODES = ("bvh", "stream")
MASK_LENSES = {"pinhole": None, "dof": (0.25, 5.0)}


def mask_scene(mode, device, monkeypatch):
    d = bvh_scene_dict("mixed-noground")
    if mode == "stream":
        return forced_stream(d, device, monkeypatch)
    return tscene.from_dict(d, device=device)[0]


def mask_cfg(lens):
    if MASK_LENSES[lens] is None:
        return ttrace.TraceConfig()
    L, F = MASK_LENSES[lens]
    return ttrace.TraceConfig(depth_of_field=True, dof_lens_radius=L,
                              dof_focus_distance=F)


@pytest.mark.parametrize("lens", list(MASK_LENSES))
@pytest.mark.parametrize("mode", MASK_MODES + ("ico2561",))
def test_mask_table_equals_plain(cuda, mode, lens, monkeypatch, tmp_path):
    """The pre-pass writes mask_table_plain's table bit for bit, and is
    counted under mask_table (the walk builds the same rows in shared
    memory with the same code, held by test_mask_walk_equals_plain)."""
    if mode == "ico2561":
        s = tscene.from_dict(ico2561_dict(tmp_path), device=cuda)[0]
    else:
        s = mask_scene(mode, cuda, monkeypatch)
    cfg = mask_cfg(lens)
    tmk.reset_launches()
    _, launch = tmk.prepare_pixel_mask(s, width=200, height=150, cfg=cfg)
    launch.prepass()
    torch.cuda.synchronize()
    kernel = tmk.MASKS[tmk._kernel_mode(s)]
    assert (tmk.LAUNCHES["mask_table"], tmk.LAUNCHES[kernel]) == (1, 0)
    want = tmk.mask_table_plain(s, launch.cam, cfg)
    assert launch.table.shape == want.shape
    assert torch.equal(launch.table.view(torch.int32),
                       want.view(torch.int32))


@pytest.mark.parametrize("in_place", [False, True], ids=["smem", "in-place"])
@pytest.mark.parametrize("size", [(1, 1), (33, 7), (799, 601)],
                         ids=["1x1", "33x7", "799x601"])
@pytest.mark.parametrize("mode", MASK_MODES)
def test_mask_walk_equals_plain(cuda, mode, size, in_place, monkeypatch):
    """K6 and K6-stream, pinhole and with depth of field, at sizes with
    partial tiles and partial blocks, the table built in shared memory and
    read in place (the budget lowered): equal to the plain version, with
    one walk launch each, after a pre-pass launch where it reads the table
    in place."""
    s = mask_scene(mode, cuda, monkeypatch)
    if in_place:
        monkeypatch.setattr(tmk, "MASK_SMEM_BYTES", 1024)
    W, H = size
    kernel = tmk.MASKS[mode]
    for lens in MASK_LENSES:
        cfg = mask_cfg(lens)
        tmk.reset_launches()
        got = tmk.pixel_mask(s, width=W, height=H, cfg=cfg)
        want = tmk.pixel_mask_plain(s, width=W, height=H, cfg=cfg)
        assert torch.equal(got, want)
        launched = {k: v for k, v in tmk.LAUNCHES.items() if v}
        expect = {kernel: 1}
        if in_place:
            expect.update(mask_table=1, pixel_mask_ldg=1)
        if cfg.depth_of_field:
            expect["mask_dof"] = 1
        assert launched == expect
        if size == (799, 601):
            assert want.any() and (~want).any()


# K2 on Hopper and the masks' camera row built on the card. K2's scenes:
# the bench scene (5 spheres), the icosphere golden and ring-300 without
# its ground, both without a BVH (loop mode).
K2_SCENES = {"bench": lambda: scene_dict(SCENES[0]),
             "icosphere-loop": icosphere_dict,
             "ring300-noground-loop": lambda: bvh_scene_dict(
                 "ring300-noground")}


def k2_scene(name, device):
    loop = name.endswith("-loop")
    s = tscene.from_dict(K2_SCENES[name](), device=device,
                         build_accel=False if loop else None)[0]
    assert tmk._kernel_mode(s) == ("loop" if loop else "unroll")
    return s


@pytest.mark.parametrize("up", [1.0, 2.0], ids=["up1", "up2"])
@pytest.mark.parametrize("lens", list(MASK_LENSES))
@pytest.mark.parametrize("go", [True, False], ids=["go", "lookat"])
@pytest.mark.parametrize("name", ["bench", "textured_mirror_demo"])
def test_mask_camera_equals_plain(cuda, name, go, lens, up):
    """rt_mask_camera (the routine every mask block runs in its prologue)
    writes _mask_camera's row, computed by PyTorch on the card, bit for
    bit, counted under mask_camera alone."""
    if name == "bench":
        s = scene_on(SCENES[0], cuda)
    else:
        s = tscene.load(os.path.join(ASSETS, f"{name}.json"),
                        device=cuda)[0]
    if up != 1.0:
        s = dataclasses.replace(s, camera=dataclasses.replace(
            s.camera, up=s.camera.up * up))
    cfg = mask_cfg(lens)
    for W, H in ((800, 600), (33, 7), (1, 1)):
        _, launch = tmk.prepare_pixel_mask(s, width=W, height=H, cfg=cfg,
                                           go_camera=go)
        tmk.reset_launches()
        got = launch.cam
        assert {k: v for k, v in tmk.LAUNCHES.items() if v} == {
            "mask_camera": 1}
        want = tmk._mask_camera(s, W, H, cfg, go)
        assert got.shape == want.shape == (18,)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
            W, H, (got != want).nonzero()[:, 0].tolist())


@pytest.mark.parametrize("budget", ["smem", "past-budget"])
@pytest.mark.parametrize("size", [(1, 1), (33, 7), (799, 601)],
                         ids=["1x1", "33x7", "799x601"])
@pytest.mark.parametrize("name", list(K2_SCENES))
def test_k2_equals_plain_sizes(cuda, name, size, budget, monkeypatch):
    """K2, pinhole and with depth of field, at sizes with partial tiles,
    its rows in shared memory and past the budget (lowered to two rows: a
    chunk at a time): equal to the plain version on the kernel's own
    camera row, with exactly its own launches counted. (Every pixel of
    the icosphere frame passes: the camera sits inside its ground
    sphere's inflated bound.)"""
    s = k2_scene(name, cuda)
    if budget == "past-budget":
        monkeypatch.setattr(tmk, "MASK_SMEM_BYTES",
                            4 * (tmk.MASK_CAM + 2 * tmk.MASK_LEAF))
    W, H = size
    for lens in MASK_LENSES:
        cfg = mask_cfg(lens)
        tmk.reset_launches()
        got = tmk.pixel_mask(s, width=W, height=H, cfg=cfg)
        launched = {k: v for k, v in tmk.LAUNCHES.items() if v}
        _, launch = tmk.prepare_pixel_mask(s, width=W, height=H, cfg=cfg)
        want = tmk.pixel_mask_plain(s, width=W, height=H, cfg=cfg,
                                    cam=launch.cam)
        assert torch.equal(got, want)
        expect = {"pixel_mask": 1}
        if budget == "past-budget":
            expect["pixel_mask_chunked"] = 1
        if cfg.depth_of_field:
            expect["mask_dof"] = 1
        assert launched == expect
        if size == (799, 601) and name != "icosphere-loop":
            assert want.any() and (~want).any()


def test_mask_card_path_builds_nothing_on_the_host(cuda):
    """On the card a mask launch needs no host-built camera row, bounding
    spheres, tree or plane table: with _mask_camera, _bsphere_table,
    _mask_tree, torch.cat, torch.stack and torch.tensor made to raise, K2, K6 and K6-stream still launch and give the plain
    version's mask."""
    cases = (("pixel_mask", lambda mp: scene_on(SCENES[0], cuda)),
             ("pixel_mask", lambda mp: k2_scene("icosphere-loop", cuda)),
             ("pixel_mask_bvh", lambda mp: mask_scene("bvh", cuda, mp)),
             ("pixel_mask_stream", lambda mp: mask_scene("stream", cuda,
                                                         mp)))

    def boom(*a, **k):
        raise AssertionError("a host-built table on the card path")

    for kernel, make in cases:
        with pytest.MonkeyPatch.context() as mp:
            s = make(mp)
            for lens in MASK_LENSES:
                cfg = mask_cfg(lens)
                want = tmk.pixel_mask_plain(s, width=200, height=150,
                                            cfg=cfg)
                with pytest.MonkeyPatch.context() as no_host:
                    for fn in ("_mask_camera", "_bsphere_table",
                               "_mask_tree"):
                        no_host.setattr(tmk, fn, boom)
                    for fn in ("cat", "stack", "tensor"):
                        no_host.setattr(torch, fn, boom)
                    tmk.reset_launches()
                    got = tmk.pixel_mask(s, width=200, height=150, cfg=cfg)
                    assert tmk.LAUNCHES[kernel] == 1
                assert torch.equal(got, want)


# ------------------------------------------------ the production loop ----

ADAPTIVE = dict(width=64, height=48, min_spp=4, max_spp=16, batch=4,
                rel_tol=0.05, abs_tol=1e-3)


def adaptive_scene(name, device, monkeypatch):
    """The bench scene (K2 + K1), ring100 (K6 + K3+K4) or ring100 forced
    into stream mode (K6-stream + K5; glassy, so at depth 12 its batches
    run the full-capacity ladder)."""
    if name == "bench":
        return scene_on(SCENES[0], device)
    if name == "ring100":
        return tscene.from_dict(bvh_scene_dict("ring100"), device=device)[0]
    return forced_stream(bvh_scene_dict("ring100"), device, monkeypatch)


@pytest.mark.parametrize("name", ["bench", "ring100", "stream"])
def test_adaptive_batches_equal_plain(cuda, name, monkeypatch):
    """The trace launches of an adaptive batch with s0 > 0, read through
    render_adaptive's hook (each ladder segment's own output), equal the
    plain version bit for bit; the ladder never overflows; device mode
    reads the device once a test round."""
    from raytrace_tpu_torch import adaptive as tad
    s = adaptive_scene(name, cuda, monkeypatch)
    cfg = ttrace.TraceConfig(max_depth=12 if name == "stream" else 8,
                             shadow_samples=4)
    split = tad._split_spec(s, cfg)
    assert bool(split) == (name == "stream")
    rounds, segs, ovs = [], [], []

    def hook(stage, **v):
        if stage == "round":
            rounds.append(v)
        elif stage == "trace":
            ovs.append(v["overflow"])
        elif stage == "segment" and len(rounds) == 2:
            segs.append(dict(v, rad=v["rad"].clone()))

    tmk.reset_launches()
    img, spp = tad.render_adaptive(s, cfg=cfg, hook=hook, device=cuda,
                                   **ADAPTIVE)
    assert rounds[1]["s0"] > 0 and segs
    assert (spp[spp > 0] >= 4).all() and spp.max() <= 16
    assert all(int(o) == 0 for o in ovs)
    for v in segs:
        last = v["state"] is None
        kw = dict(start_bounce=v["b0"], end_bounce=None if last else v["b1"],
                  return_state=not last)
        if v["b0"] > 0:
            kw.update(init_throughput=v["throughput"],
                      init_alive=v["alive"])
        want = ttrace.trace(s, v["origin"], v["direction"], v["pix"],
                            v["samp"], cfg, **kw)
        if last:
            assert torch.equal(v["rad"], want)
        else:
            alive = want[1]["alive"] > 0
            assert torch.equal(v["rad"], want[0])
            assert torch.equal(v["state"]["alive"], want[1]["alive"])
            for k in ("origin", "direction", "throughput"):
                assert torch.equal(v["state"][k][alive], want[1][k][alive])
    kernel = {"bench": "trace_unroll", "ring100": "trace_bvh",
              "stream": "trace_stream"}[name]
    assert tmk.LAUNCHES[kernel] >= len(rounds)


def test_adaptive_device_equals_host_and_tol_zero(cuda):
    from raytrace_tpu_torch import adaptive as tad
    s = scene_on(SCENES[0], cuda)
    cfg = ttrace.TraceConfig(max_depth=8, shadow_samples=4)
    img_d, spp_d = tad.render_adaptive(s, cfg=cfg, accum="device",
                                       device=cuda, **ADAPTIVE)
    img_h, spp_h = tad.render_adaptive(s, cfg=cfg, accum="host",
                                       device=cuda, **ADAPTIVE)
    assert (spp_d == spp_h).mean() >= 0.999
    gate(torch.from_numpy(img_d), torch.from_numpy(img_h))
    kw = dict(ADAPTIVE, min_spp=8, max_spp=8, rel_tol=0.0, abs_tol=0.0)
    img0, spp0 = tad.render_adaptive(s, cfg=cfg, as_numpy=False, device=cuda,
                                     **kw)
    ref = trender.render_wavefront(s, width=64, height=48, samples=8,
                                   cfg=cfg)
    assert bool((spp0[spp0 > 0] == 8).all())
    gate(img0, ref)


def test_adaptive_resume_is_bit_exact_on_card(cuda, tmp_path, monkeypatch):
    from raytrace_tpu_torch import adaptive as tad
    s = scene_on(SCENES[0], cuda)
    cfg = ttrace.TraceConfig(max_depth=8, shadow_samples=4)
    kw = dict(ADAPTIVE, cfg=cfg, device=cuda)
    ref_img, ref_spp = tad.render_adaptive(s, **kw)
    real, calls = tad._save_ckpt, [0]

    def dying(*a, **k):
        real(*a, **k)
        calls[0] += 1
        if calls[0] >= 2:
            raise KeyboardInterrupt

    ckpt = str(tmp_path / "adaptive.ckpt.npz")
    monkeypatch.setattr(tad, "_save_ckpt", dying)
    with pytest.raises(KeyboardInterrupt):
        tad.render_adaptive(s, checkpoint_path=ckpt, **kw)
    monkeypatch.setattr(tad, "_save_ckpt", real)
    img, spp = tad.render_adaptive(s, checkpoint_path=ckpt, **kw)
    assert (img == ref_img).all() and (spp == ref_spp).all()
    monkeypatch.setattr(tad, "_split_spec", lambda scene, cfg: (4, 7))
    with pytest.raises(ValueError, match="split"):
        tad.render_adaptive(s, checkpoint_path=ckpt, **kw)


@pytest.mark.parametrize("name", ["bench", "ring100"])
def test_aovs_and_denoise_match_the_cpu(cuda, name, monkeypatch):
    """render_aovs and denoise on the card against the same calls on the
    CPU: bit fields equal, floats within an absolute 1e-5."""
    from raytrace_tpu_torch import aov, denoising
    s = adaptive_scene(name, cuda, monkeypatch)
    a = aov.render_aovs(s, width=200, height=150, as_numpy=False,
                        device=cuda)
    b = aov.render_aovs(s.to("cpu"), width=200, height=150, as_numpy=False,
                        device="cpu")
    for k in ("hit", "mat_id", "front_face"):
        assert torch.equal(a[k].cpu(), b[k]), k
    for k in ("depth", "position", "normal", "albedo"):
        assert float((a[k].cpu() - b[k]).abs().max()) <= 1e-5, k
    g = torch.Generator().manual_seed(0)
    img = torch.rand((150, 200, 3), generator=g)
    var = torch.rand((150, 200), generator=g) * 1e-3
    for passes in (1, 3):
        for v in (None, var):
            got = denoising.denoise(img.to(cuda), a, passes=passes,
                                    variance=None if v is None
                                    else v.to(cuda), device=cuda)
            want = denoising.denoise(img, b, passes=passes, variance=v,
                                     device="cpu")
            assert float((got.cpu() - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("name", ["simple", "cube"])
def test_diff_card_matches_cpu(cuda, name):
    """render_and_grad at 12x8, 2 spp, depth 3 on the card against the CPU:
    the image within atol 1e-5, every gradient leaf finite and within
    rtol 1e-4, atol 1e-6; the scan loop's image equal to the while loop's
    on the card bit for bit."""
    from raytrace_tpu_torch import diff
    from raytrace_tpu_torch.bench.suite import diff_scene_dict
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=2)
    s = tscene.from_dict(diff_scene_dict(name), device=cuda)[0]
    img, g = diff.render_and_grad(s, 12, 8, samples=2, cfg=cfg)
    img_c, g_c = diff.render_and_grad(s.to("cpu"), 12, 8, samples=2,
                                      cfg=cfg)
    assert float((img.cpu() - img_c).abs().max()) <= 1e-5
    for grp, sub in g.items():
        for f, v in sub.items():
            assert bool(torch.isfinite(v).all()), (grp, f)
            torch.testing.assert_close(v.cpu(), g_c[grp][f], rtol=1e-4,
                                       atol=1e-6)
    ref = trender.render_band(s, 0, width=12, height=8, band_h=8, samples=2,
                              cfg=cfg)
    assert torch.equal(ref, img)


def test_diff_keep_accel_equals_brute_on_card(cuda):
    """keep_accel on the card (the plain walk without autograd, the
    winner's t straight-through) against brute force on grid-1001 at
    16x12: the image bit for bit, the material and light gradients within
    rtol 1e-3, atol 1e-6."""
    from raytrace_tpu_torch import diff
    from raytrace_tpu_torch.bench.suite import grad_grid_scene_dict
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=2)
    s = tscene.from_dict(grad_grid_scene_dict(), device=cuda)[0]
    img_a, g_a = diff.render_and_grad(s, 16, 12, samples=2, cfg=cfg,
                                      keep_accel=True)
    img_b, g_b = diff.render_and_grad(s, 16, 12, samples=2, cfg=cfg)
    assert torch.equal(img_a, img_b)
    for grp in ("materials", "lights"):
        for f, v in g_a[grp].items():
            torch.testing.assert_close(v, g_b[grp][f], rtol=1e-3, atol=1e-6)
