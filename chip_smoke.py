#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
the port builds, runs and agrees with itself on the card.

    python3 chip_smoke.py

Phases, in order (each prints a line before and after, with its seconds):

  env               card name and power limit, torch and CUDA versions
  build             one nvcc call for every kernel; registers, shared
                    memory and spills from -Xptxas -v
  k2_check          K2 (pixel mask, brute force) against its plain version
                    at 800x600 on the three demo scenes: masks equal
  k1_check          K1 (bounce megakernel, unroll mode) against its plain
                    version on the lanes of a 64x48 frame, 4 spp, depth 50,
                    three scenes, under the image gate
  render_check      the main path (K2, compaction, K1) against the dense
                    plain path at 800x600, 4 spp, depth 50 on the bench
                    scene, under the image gate
  k6_check          K6 (pixel mask, BVH walk) against its plain version at
                    800x600 on ring-1000 and the mixed scene, and on both
                    without what covers the whole frame (their frames
                    must hold hits and misses): masks equal
  k3_check          K3+K4 (bounce megakernel, bvh mode) against its plain
                    version on the lanes of a 64x48 frame, 4 spp, depth 50,
                    ring-1000 and the mixed scene: max lane error 0 or the
                    image gate
  render_check_bvh  the main path (K6, compaction, K3+K4) against the
                    dense plain path at 160x120, 4 spp, depth 50 on
                    ring-1000, under the image gate
  k7_check          K7 (loop mode: brute force without a BVH) against its
                    plain version on the lanes of a 64x48 frame, 4 spp,
                    depth 50, on the icosphere golden scene without its
                    BVH (tables in shared memory) and on ring-2500 without
                    one (tables past the budget, read through __ldg): max
                    lane error 0 or the image gate
  k1ext_check       the extended body (K1-ext) on the same lanes: K1 on
                    textured_mirror_demo and the extended_textured golden
                    scene, K3+K4 on smooth_shading_demo; image gate, with
                    the max lane error printed
  bounds_check      max_depth 100, 20 lights and 80 soft-shadow samples on
                    K1, K3+K4 and K7 (a few hundred lanes each) against the
                    plain version: max lane error 0 or the image gate
  bench             Renderer().render of the bench workload (800x600,
                    100 spp, depth 50, 16 soft-shadow rays, seed 0): one
                    warm-up, then 3 timed frames; launch counts are reset
                    just before the first timed frame and read just after
  bench_bvh         the same on ring-1000 through K6 and K3+K4 (one timed
                    frame instead of 3 when a frame takes over 30 s)
  bench_textured    the same on textured_mirror_demo (its look-at camera)
                    through K2 and K1-ext
  bench_smooth      the same on smooth_shading_demo (its look-at camera)
                    through K6 and K3+K4 with vertex normals
  bench_loop        the same on the icosphere golden scene without its BVH
                    (the go camera) through K2 and K7
  kernels           K1 and K3+K4 against their plain versions on the bench
                    frames' own lanes (all of them for K1, a strided subset
                    of about 20k for K3+K4, whose main-path launches must
                    give the same lanes); each kernel's time per launch at
                    the main path's own shapes (CUDA events; the trace runs
                    in chunks of TRACE_LANES lanes, so ms x launches is a
                    frame's kernel time) beside its plain version's and
                    its bound for the same work; then K7 and K1-ext (and
                    K3+K4 with vertex normals) the same way at the three
                    new bench frames, on a strided subset of about 20k of
                    their lanes for the plain version; registers, stack
                    and spills of every kernel from the build

The image gate is the goldens gate of tests/test_goldens.py: at most 0.1%
of pixels off by more than 1e-3 and a mean absolute error below 1e-4.

The bench scene is assets/sphere_reflections_light.json with the camera
mirrored to +Z (the shipped -Z position faces away from the geometry
under the reference camera). Ring-1000 is the reference benchmark's
1000-sphere ring (bench/suite.py:ring_scene_dict); the mixed scene adds a
prism, two cubes and a plane to a 90-sphere ring (124 primitives;
bench/suite.py:mixed_scene_dict). Every pixel of both passes the mask,
so k6_check adds both without their ground and back wall. The slice of
meshes, vertex normals, extended kinds and textures runs the three demo
scenes of assets/ that need it and two golden scenes of
tests/make_goldens.py (copied into bench/suite.py:golden_scene_dict,
since this script imports nothing of the JAX package). The last
two lines of output are the JSON kernel record and the contract line. Any
failure raises and exits non-zero with no contract line; without a GPU
the script exits non-zero at once.
"""

import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time

# A hang ends the run with a traceback and a non-zero exit.
faulthandler.dump_traceback_later(480, exit=True)

REPO = os.path.dirname(os.path.abspath(__file__))
W, H, SPP, DEPTH, SOFT = 800, 600, 100, 50, 16
SCENES = ("sphere_reflections_light", "two_red_cubes_scene",
          "final_silver_prism_purple_cube")
BVH_SCENES = ("ring1000", "mixed")
MASK_SCENES = BVH_SCENES + ("ring1000-noground", "mixed-noground")
LOOP_LDG_RING = 2500  # ring spheres: tables past K7's shared-memory budget
PLAIN_CHUNK = 2048    # lanes per call of the plain brute-force engine
K3_SUBSET = 20000   # lanes of the bench frame checked against the plain
SLOW_FRAME_S = 30.0
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and fp32 instructions/s
# outside the tensor cores: the sheet's 67 TFLOP/s counts an FMA as two
# operations, and the kernels are built without FMA contraction, so each
# counted add, multiply, compare, divide or square root is one of 33.5e12
# per second. Used for the kernels' bounds only.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12


class Phase:
    """Print a line before and after a phase, with its seconds."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}: start", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        state = "done" if exc_type is None else "FAILED"
        print(f"== {self.name}: {state} in {dt:.1f} s", flush=True)
        return False


def image_gate(img, ref, what):
    """The goldens gate; raises when it fails."""
    import torch
    diff = (img - ref).abs().amax(dim=-1)
    frac = float((diff > 1e-3).float().mean())
    mean = float((img - ref).abs().mean())
    print(f"   {what}: pixels off >1e-3 {frac:.6f}, mean abs {mean:.3e}, "
          f"max {float(diff.max()):.3e}", flush=True)
    if not (frac <= 1e-3 and mean < 1e-4 and bool(torch.isfinite(img).all())):
        raise AssertionError(f"{what}: image gate failed")


def load_scene(name, device):
    from raytrace_tpu_torch import scene as scene_mod
    with open(os.path.join(REPO, "assets", f"{name}.json")) as f:
        data = json.load(f)
    # mirror the camera to +Z: the shipped -Z camera sees nothing
    data["camera"]["position"][2] = -data["camera"]["position"][2]
    return scene_mod.from_dict(data, device=device)[0]


def bvh_scene(name, device):
    """A bvh-mode scene of bench/suite.py:bvh_scene_dict by name."""
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.bench.suite import bvh_scene_dict
    return scene_mod.from_dict(bvh_scene_dict(name), device=device)[0]


def asset_scene(name, device):
    """An asset of the slice loaded from its file (mesh paths resolve
    against assets/); rendered with its own look-at camera."""
    from raytrace_tpu_torch import scene as scene_mod
    return scene_mod.load(os.path.join(REPO, "assets", f"{name}.json"),
                          device=device)[0]


def golden_scene(name, device, build_accel=None):
    """A golden scene of tests/make_goldens.py (bench/suite.py's copy)."""
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.bench.suite import golden_scene_dict
    return scene_mod.from_dict(golden_scene_dict(name)[0], device=device,
                               build_accel=build_accel)[0]


def with_lights(scene, n):
    """The scene with n point lights (run-time bound checks)."""
    import dataclasses
    import torch
    from raytrace_tpu_torch import scene as scene_mod
    dev = scene.device
    i = torch.arange(n, dtype=torch.float32, device=dev)
    pos = torch.stack([4.0 - 0.4 * i, torch.full_like(i, 6.0),
                       5.0 - 0.3 * i], 1)
    return dataclasses.replace(scene, lights=scene_mod.Lights(
        position=pos, color=torch.ones((n, 3), device=dev),
        intensity=torch.full((n,), 3.0, device=dev)))


def plain_trace(scene, o, d, pix, samp, cfg):
    """The plain version over lanes in chunks of PLAIN_CHUNK: lanes are
    independent, so the result is the one-call result, and the brute-force
    soft-shadow batches stay small on big tables."""
    import torch
    from raytrace_tpu_torch import trace as trace_mod
    return torch.cat([trace_mod.trace(scene, *(t[i:i + PLAIN_CHUNK]
                                               for t in (o, d, pix, samp)),
                                      cfg)
                      for i in range(0, o.shape[0], PLAIN_CHUNK)])


def ptxas_kernels(lines):
    """{kernel entry: (registers, stack bytes, spill bytes)} from the
    build's -Xptxas -v report."""
    import re
    out, cur = {}, None
    for ln in lines:
        m = re.search(r"(?:entry function|Function properties for) '?"
                      r"([A-Za-z_]\w*)", ln)
        if m:
            cur = m.group(1)
            out.setdefault(cur, [None, 0, 0])
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[cur][1] = int(m.group(1))
            out[cur][2] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def cuda_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def lanes_of(scene, width, height, samples, cfg, chunks=False,
             go_camera=True):
    """The trace's input on the main path: the compacted pixels and the
    rays of their lanes, read from render_wavefront through its stage hook
    and joined over its trace chunks; with ``chunks``, also the lane count
    of each trace launch."""
    import torch
    from raytrace_tpu_torch import renderer as r
    seen = {"px": [], "origin": [], "direction": [], "pix": [], "samp": []}

    def hook(stage, **values):
        if stage == "lane_rays":
            for k in seen:
                seen[k].append(values[k])

    r.render_wavefront(scene, width=width, height=height, samples=samples,
                       cfg=cfg, go_camera=go_camera, hook=hook)
    out = tuple(torch.cat(seen[k]).contiguous() for k in seen)
    if chunks:
        return out + ([int(o.shape[0]) for o in seen["origin"]],)
    return out


def chunk_launches(mk, scene, lanes, sizes, cfg, counters=None):
    """Prepare the trace kernel on the main path's own chunks of the frame's
    lanes: returns (out joined over the chunks, a function that launches
    every chunk once)."""
    import torch
    o, d, pix, samp = (t.split(sizes) for t in lanes)
    cnt = counters.split(sizes) if counters is not None else [None] * len(o)
    prepared = [mk.prepare_trace(scene, *c, cfg, counters=k)
                for c, k in zip(zip(o, d, pix, samp), cnt)]

    def launch_all():
        for _, launch in prepared:
            launch()

    return (lambda: torch.cat([out for out, _ in prepared])), launch_all


def pixel_image(px, rad, width, height, samples):
    import torch
    img = torch.zeros((width * height, 3), device=rad.device)
    img.index_add_(0, px, rad.reshape(-1, samples, 3).sum(dim=1))
    return (img / samples).reshape(height, width, 3)


def frame_stages(r, scene):
    """Milliseconds of each stage of one bench frame (render_wavefront,
    timed through its stage hook, then tonemap and the copy to the host;
    each stage is ended by a synchronise, so the sum exceeds a frame),
    and the hit-pixel count."""
    import torch
    from raytrace_tpu_torch import renderer as rmod
    from raytrace_tpu_torch.ops import tonemap
    ms = {}
    last = [time.perf_counter()]
    k = []

    def mark(stage, **values):
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[stage] = ms.get(stage, 0.0) + (now - last[0]) * 1e3
        last[0] = now
        if stage == "count":
            k.append(values["k"])

    img = rmod.render_wavefront(scene, width=W, height=H, samples=SPP,
                                cfg=r.trace_config(), go_camera=r.go_camera,
                                hook=mark)
    tonemap.tonemap_rgb8(img).cpu()
    mark("tonemap_copy")
    return {s: round(v, 3) for s, v in ms.items()}, k[0]


def bench(scene, mk, what, slow_cut, go_camera=True):
    """Renderer().render at the bench settings: one warm-up, then 3 timed
    frames (1 when ``slow_cut`` and the warm-up took over SLOW_FRAME_S).
    Returns the launch counts of the first timed frame."""
    import torch
    from raytrace_tpu_torch import renderer as rmod
    r = rmod.Renderer(device=torch.device("cuda"))
    r.set_samples(SPP)
    r.set_max_depth(DEPTH)
    r.go_camera = go_camera
    t0 = time.perf_counter()
    r.render(scene, W, H)  # warm-up
    warm = time.perf_counter() - t0
    n = 1 if slow_cut and warm > SLOW_FRAME_S else 3
    if n == 1:
        print(f"   the warm-up frame took {warm:.1f} s > {SLOW_FRAME_S} s: "
              "timing 1 frame, not 3", flush=True)
    times = []
    for i in range(n):
        if i == 0:
            mk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = r.render(scene, W, H)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(mk.LAUNCHES)
    if img.shape != (H, W, 3) or str(img.dtype) != "uint8":
        raise AssertionError(f"bad image {img.shape} {img.dtype}")
    nonblack = float((img.sum(axis=2) > 0).mean())
    if nonblack <= 0.0:
        raise AssertionError(f"the {what} frame is black")
    with tempfile.TemporaryDirectory() as tmp:
        r.save_image(img, os.path.join(tmp, "bench.png"))
    best = sorted(times)[len(times) // 2]
    stages, k_px = frame_stages(r, scene)
    print(f"   {what}: stages of one frame, ms (host clock, synchronised): "
          f"{stages}", flush=True)
    print(f"   {what}: frame seconds {[round(t, 4) for t in times]}; median "
          f"{best:.4f} s = {W * H * SPP / best:.4e} camera samples/s; "
          f"hit pixels {k_px}, lanes {k_px * SPP}; non-black "
          f"{nonblack:.4f}; launches {launches}", flush=True)
    return launches


def k1_ops(scene, cnt):
    """Operations K1 ran, from its per-lane work counters and the
    per-test costs read off csrc/: every add, multiply, divide, square
    root, compare and min/max counts one. Shading arithmetic is left out,
    so the count, and the bound from it, is low."""
    import torch
    g = scene.geometry
    ns, nt = g.sph_center.shape[0], g.n_hit_tris
    npl, nb = g.pl_point.shape[0], g.box_min.shape[0]
    c = [int(x) for x in cnt.to(torch.int64).sum(0)]
    closest, hard, soft, cheap, costly = c
    inv = 6 if nb else 0
    per_closest = 6 + inv + 25 * ns + 54 * nt + 17 * npl + 27 * nb
    cheap_cost = 17 if npl else 25      # plane 17, sphere 25
    costly_cost = 27 if nb else 65      # box 27, division-free triangle 65
    return (closest * per_closest + (hard + soft) * (6 + inv) + soft * 104
            + cheap * cheap_cost + costly * costly_cost), c


def k3_ops(cnt):
    """Operations of K3+K4 and of K4 alone, from the per-lane work
    counters (megakernel.prepare_trace_bvh) and per-test costs read off
    csrc/ as for K1: slab test 21, sphere 25, triangle 54, plane 17 (the
    cheaper of plane and box), per ray 12 (direction terms); fused walk:
    slab 46 (with the cone growth), (ray, sphere) 17, (ray, triangle) 25,
    and 104 per soft ray for its direction (ball, normalise)."""
    import torch
    c = [int(x) for x in cnt.to(torch.int64).sum(0)]
    closest, hard, soft, nodes, sph, tri, fnodes, fsph, ftri, brute = c
    k4 = soft * 104 + fnodes * 46 + fsph * 17 + ftri * 25
    total = ((closest + hard) * 12 + nodes * 21 + sph * 25 + tri * 54
             + brute * 17 + k4)
    return total, k4, c


def bound(ops, n_bytes):
    t_ops, t_bytes = ops / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from raytrace_tpu_torch import renderer as rmod
        from raytrace_tpu_torch import trace as trace_mod
        from raytrace_tpu_torch.ops import _build
        from raytrace_tpu_torch.ops import megakernel as mk
    except ImportError as e:
        print(f"chip_smoke: the raytrace_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    record = {}

    with Phase("env"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        gpu_line = smi[0].strip() if smi else "nvidia-smi: no output"
        print(gpu_line, flush=True)
        print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} device(s)", flush=True)

    with Phase("build"):
        res = _build.build()
        print(f"   nvcc {'built' if res.built else 'cached'} in "
              f"{res.seconds:.1f} s -> {os.path.relpath(res.path, REPO)}",
              flush=True)
        for ln in res.ptxas:
            if ("Used" in ln or "spill" in ln or "Compiling" in ln):
                print(f"   {ln}", flush=True)
        _build.library()

    cfg = trace_mod.TraceConfig(max_depth=DEPTH, shadow_samples=SOFT, seed=0)
    scenes = {n: load_scene(n, dev) for n in SCENES}
    bvh_scenes = {n: bvh_scene(n, dev) for n in MASK_SCENES}
    for n, s in bvh_scenes.items():
        if mk._kernel_mode(s) != "bvh":
            raise AssertionError(f"{n} is not a bvh-mode scene")

    with Phase("k2_check"):
        for name, s in scenes.items():
            got = mk.pixel_mask(s, width=W, height=H, cfg=cfg)
            want = mk.pixel_mask_plain(s, width=W, height=H, cfg=cfg)
            missing = int((want & ~got).sum())
            extra = int((got & ~want).sum())
            print(f"   {name}: {int(got.sum())} of {W * H} pixels, "
                  f"{missing + extra} differ ({missing} missing, {extra} "
                  "extra)", flush=True)
            if not torch.equal(got, want):
                raise AssertionError(f"K2 differs from its plain version "
                                     f"on {name}")
            if name == SCENES[0]:
                record["k2_err"] = float(
                    (got.float() - want.float()).abs().max())

    with Phase("k1_check"):
        for name, s in scenes.items():
            px, o, d, pix, samp = lanes_of(s, 64, 48, 4, cfg)
            got = mk.trace(s, o, d, pix, samp, cfg)
            want = trace_mod.trace(s, o, d, pix, samp, cfg)
            err = float((got - want).abs().max())
            print(f"   {name}: {o.shape[0]} lanes, max lane error "
                  f"{err:.3e}", flush=True)
            image_gate(pixel_image(px, got, 64, 48, 4),
                       pixel_image(px, want, 64, 48, 4), f"K1 {name}")

    with Phase("render_check"):
        rcfg = trace_mod.TraceConfig(max_depth=DEPTH, shadow_samples=SOFT)
        main_img = rmod.render_wavefront(scenes[SCENES[0]], width=W,
                                         height=H, samples=4, cfg=rcfg)
        ref_img = rmod.render_band(scenes[SCENES[0]], 0, width=W, height=H,
                                   band_h=H, samples=4, cfg=rcfg)
        image_gate(main_img, ref_img, "main path vs dense plain path")

    with Phase("k6_check"):
        for name, s in bvh_scenes.items():
            got = mk.pixel_mask(s, width=W, height=H, cfg=cfg)
            want = mk.pixel_mask_plain(s, width=W, height=H, cfg=cfg)
            missing = int((want & ~got).sum())
            extra = int((got & ~want).sum())
            print(f"   {name}: {s.accel.n_nodes} nodes, {int(got.sum())} of "
                  f"{W * H} pixels, {missing + extra} differ ({missing} "
                  f"missing, {extra} extra)", flush=True)
            if name.endswith("-noground") and not (want.any()
                                                   and (~want).any()):
                raise AssertionError(f"{name}: the frame must hold both "
                                     "hits and misses")
            if not torch.equal(got, want):
                raise AssertionError(f"K6 differs from its plain version "
                                     f"on {name}")
            if name == BVH_SCENES[0]:
                record["k6_err"] = float(
                    (got.float() - want.float()).abs().max())

    with Phase("k3_check"):
        for name in BVH_SCENES:
            s = bvh_scenes[name]
            px, o, d, pix, samp = lanes_of(s, 64, 48, 4, cfg)
            got = mk.trace(s, o, d, pix, samp, cfg)
            want = trace_mod.trace(s, o, d, pix, samp, cfg)
            err = float((got - want).abs().max())
            print(f"   {name}: {o.shape[0]} lanes, max lane error "
                  f"{err:.3e}", flush=True)
            if err > 0.0:
                image_gate(pixel_image(px, got, 64, 48, 4),
                           pixel_image(px, want, 64, 48, 4), f"K3 {name}")

    with Phase("render_check_bvh"):
        ring = bvh_scenes[BVH_SCENES[0]]
        rcfg = trace_mod.TraceConfig(max_depth=DEPTH, shadow_samples=SOFT)
        main_img = rmod.render_wavefront(ring, width=160, height=120,
                                         samples=4, cfg=rcfg)
        ref_img = rmod.render_band(ring, 0, width=160, height=120,
                                   band_h=120, samples=4, cfg=rcfg)
        image_gate(main_img, ref_img, "bvh main path vs dense plain path")

    with Phase("k7_check"):
        loop_scenes = {
            "icosphere": golden_scene("mesh_smooth_icosphere", dev,
                                      build_accel=False),
            f"ring{LOOP_LDG_RING}": loop_ring_scene(LOOP_LDG_RING, dev)}
        for name, s in loop_scenes.items():
            if mk._kernel_mode(s) != "loop":
                raise AssertionError(f"{name} is not a loop-mode scene")
            in_smem = mk.loop_tables_in_smem(mk.pack_tables(s))
            if in_smem != (name == "icosphere"):
                raise AssertionError(f"{name}: tables in shared memory "
                                     f"{in_smem}")
            px, o, d, pix, samp = lanes_of(s, 64, 48, 4, cfg)
            mk.reset_launches()
            got = mk.trace(s, o, d, pix, samp, cfg)
            if mk.LAUNCHES["trace_loop"] != 1:
                raise AssertionError(f"K7 was not launched: {mk.LAUNCHES}")
            want = plain_trace(s, o, d, pix, samp, cfg)
            err = float((got - want).abs().max())
            print(f"   {name}: {s.prim_count} primitives, tables "
                  f"{'in shared memory' if in_smem else 'through __ldg'}, "
                  f"{o.shape[0]} lanes, max lane error {err:.3e}",
                  flush=True)
            if err > 0.0:
                image_gate(pixel_image(px, got, 64, 48, 4),
                           pixel_image(px, want, 64, 48, 4), f"K7 {name}")
            record.setdefault("k7_check_err", []).append(err)
            # the two table routes' speed against their bounds
            cnt = torch.zeros((o.shape[0], mk.COUNTERS), dtype=torch.int32,
                              device=dev)
            _, counted = mk.prepare_trace(s, o, d, pix, samp, cfg,
                                          counters=cnt)
            counted()
            ops, _ = k1_ops(s, cnt)
            _, launch = mk.prepare_trace(s, o, d, pix, samp, cfg)
            ms = cuda_ms(launch, 3)
            bnd, _ = bound(ops, o.shape[0] * 44)
            record[f"k7_{'smem' if in_smem else 'ldg'}"] = (ms, bnd)
            print(f"   {name}: K7 {ms:.4f} ms for {ops:.4e} ops, bound "
                  f"{bnd:.4f} ms ({bnd / ms:.0%})", flush=True)

    with Phase("k1ext_check"):
        ext = (("textured_mirror_demo", asset_scene("textured_mirror_demo",
                                                    dev), False,
                "trace_unroll"),
               ("extended_textured", golden_scene("extended_textured", dev),
                True, "trace_unroll"),
               ("smooth_shading_demo", asset_scene("smooth_shading_demo",
                                                   dev), False, "trace_bvh"))
        for name, s, go, kernel in ext:
            px, o, d, pix, samp = lanes_of(s, 64, 48, 4, cfg, go_camera=go)
            mk.reset_launches()
            got = mk.trace(s, o, d, pix, samp, cfg)
            if mk.LAUNCHES[kernel] != 1:
                raise AssertionError(f"{name}: {kernel} was not launched")
            want = trace_mod.trace(s, o, d, pix, samp, cfg)
            err = float((got - want).abs().max())
            print(f"   {name} ({kernel}): {o.shape[0]} lanes, max lane "
                  f"error {err:.3e}", flush=True)
            image_gate(pixel_image(px, got, 64, 48, 4),
                       pixel_image(px, want, 64, 48, 4), f"K1-ext {name}")
            record.setdefault("k1ext_check_err", []).append(err)

    with Phase("bounds_check"):
        bcfg = trace_mod.TraceConfig(max_depth=100, shadow_samples=80,
                                     seed=0)
        for name, s in (("unroll", scenes[SCENES[2]]),
                        ("bvh", bvh_scenes["mixed"]),
                        ("loop", loop_scenes["icosphere"])):
            s = with_lights(s, 20)
            px, o, d, pix, samp = lanes_of(s, 12, 9, 2, bcfg)
            got = mk.trace(s, o, d, pix, samp, bcfg)
            want = trace_mod.trace(s, o, d, pix, samp, bcfg)
            err = float((got - want).abs().max())
            print(f"   {name}: depth 100, 20 lights, 80 soft rays, "
                  f"{o.shape[0]} lanes, max lane error {err:.3e}", flush=True)
            if err > 0.0:
                image_gate(got, want, f"run-time bounds, {name}")

    with Phase("bench"):
        launches = bench(scenes[SCENES[0]], mk, "bench", slow_cut=False)
        for k in ("trace_unroll", "pixel_mask"):
            if launches[k] < 1:
                raise AssertionError(f"the main path never launched {k}")

    with Phase("bench_bvh"):
        launches_bvh = bench(bvh_scenes[BVH_SCENES[0]], mk, "bench_bvh",
                             slow_cut=True)
        for k in ("trace_bvh", "pixel_mask_bvh"):
            if launches_bvh[k] < 1:
                raise AssertionError(f"the bvh main path never launched {k}")

    frames = {}
    for phase, key, s, go, kernels_used in (
            ("bench_textured", "textured", ext[0][1], False,
             ("trace_unroll", "pixel_mask")),
            ("bench_smooth", "smooth", ext[2][1], False,
             ("trace_bvh", "pixel_mask_bvh")),
            ("bench_loop", "loop", loop_scenes["icosphere"], True,
             ("trace_loop", "pixel_mask"))):
        with Phase(phase):
            got = bench(s, mk, phase, slow_cut=True, go_camera=go)
            for k in kernels_used:
                if got[k] < 1:
                    raise AssertionError(f"the {phase} frame never "
                                         f"launched {k}")
            frames[key] = (s, go, got)

    with Phase("kernels"):
        kernels = kernel_rows(mk, trace_mod, scenes[SCENES[0]],
                              bvh_scenes[BVH_SCENES[0]], cfg, launches,
                              launches_bvh, record)
        kernels += slice_rows(mk, scenes, frames, cfg, record)
        regs = ptxas_kernels(res.ptxas)
        entry = {"K1": "rt_trace_unroll_kernel", "K2": "rt_pixel_mask_kernel",
                 "K3": "rt_trace_bvh_kernel", "K4": "rt_trace_bvh_kernel",
                 "K6": "rt_pixel_mask_bvh_kernel",
                 "K7": "rt_trace_loop_kernel",
                 "K1-ext": "rt_trace_unroll_kernel"}
        for row in kernels:
            fn = entry[row["name"].split()[0]]
            r_, stack, spill = regs.get(fn, (None, None, None))
            row.update(registers=r_, stack_bytes=stack, spill_bytes=spill)
            print(f"   {row['name']}: {fn} {r_} registers, {stack} B stack, "
                  f"{spill} B spills", flush=True)

    print(gpu_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def loop_ring_scene(n, device):
    """ring-n of bench/suite.py without a BVH (loop mode)."""
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.bench.suite import ring_scene_dict
    return scene_mod.from_dict(ring_scene_dict(n), device=device,
                               build_accel=False)[0]


def frame_kernel(mk, scene, cfg, go_camera, what):
    """The trace kernel of a bench frame, at the main path's own chunks of
    that frame's lanes: checks, time per launch, plain time on a strided
    subset of about K3_SUBSET lanes, bound from the work counters.
    Returns a dict of the row's numbers."""
    import torch
    from raytrace_tpu_torch import trace as trace_mod
    dev = torch.device("cuda")
    mode = mk._kernel_mode(scene)
    px, o, d, pix, samp, sizes = lanes_of(scene, W, H, SPP, cfg, chunks=True,
                                          go_camera=go_camera)
    lanes = (o, d, pix, samp)
    n, n_launch = o.shape[0], len(sizes)
    idx = torch.arange(0, n, max(1, n // K3_SUBSET), device=dev)
    sub = tuple(t[idx] for t in lanes)
    out, launch_all = chunk_launches(mk, scene, lanes, sizes, cfg)
    launch_all()
    sub_k, sub_launch = mk.prepare_trace(scene, *sub, cfg)
    sub_ms = cuda_ms(sub_launch, 1)
    if not torch.equal(out()[idx], sub_k):
        raise AssertionError(f"{what}: the main-path launches and the "
                             "subset launch disagree at the same lanes")
    plain, want = host_ms(lambda: plain_trace(scene, *sub, cfg))
    err = float((sub_k - want).abs().max())
    image_gate(sub_k, want, f"{what} at {idx.numel()} of its bench lanes "
               f"(max lane error {err:.3e})")
    ms = cuda_ms(launch_all, 2) / n_launch
    n_cnt = mk.BVH_COUNTERS if mode == "bvh" else mk.COUNTERS
    cnt = torch.zeros((n, n_cnt), dtype=torch.int32, device=dev)
    _, counted = chunk_launches(mk, scene, lanes, sizes, cfg, counters=cnt)
    counted()
    if mode == "bvh":
        ops, _, work = k3_ops(cnt)
    else:
        ops, work = k1_ops(scene, cnt)
    bnd, by = bound(ops / n_launch, n / n_launch * (12 + 12 + 4 + 4 + 12))
    print(f"   {what}: {n} lanes in {n_launch} launch(es), work {work}, "
          f"{ops:.4e} ops; per launch {ms:.4f} ms, bound {bnd:.4f} ms "
          f"({by}); kernel on {idx.numel()} lanes {sub_ms:.3f} ms vs plain "
          f"{plain:.1f} ms", flush=True)
    return dict(launches=n_launch, err=err, ms=ms, plain=plain, bound=bnd,
                by=by, plain_lanes=int(idx.numel()), ms_plain_lanes=sub_ms,
                lanes_per_frame=n)


def slice_rows(mk, scenes, frames, cfg, record):
    """The rows of K7 and K1-ext at the three bench frames of the slice
    (K1-ext's row is K1 on the textured frame; K3+K4 with vertex normals
    on the smooth frame rides along as extra keys)."""
    src = "raytrace_tpu_torch/csrc/"
    mkpy = "raytrace_tpu/ops/megakernel.py:"
    rows = []
    got = {}
    for key, kernel in (("textured", "trace_unroll"), ("smooth", "trace_bvh"),
                        ("loop", "trace_loop")):
        s, go, launches = frames[key]
        got[key] = frame_kernel(mk, s, cfg, go, f"{key} frame ({kernel})")
        if launches[kernel] != got[key]["launches"]:
            raise AssertionError(f"the {key} frame launched {kernel} "
                                 f"{launches[kernel]} times, not its chunk "
                                 f"count {got[key]['launches']}")
    t, sm, lp = got["textured"], got["smooth"], got["loop"]
    # K2, the loop frame's mask
    _, k2_launch = mk.prepare_pixel_mask(frames["loop"][0], width=W,
                                         height=H, cfg=cfg)
    record["k2_loop_ms"] = cuda_ms(k2_launch, 20)
    print(f"   K2 on the loop frame: {record['k2_loop_ms']:.4f} ms",
          flush=True)
    common = dict(route="cuda", library_ms=None)
    rows.append(dict(
        name="K7 trace_loop", source=src + "trace_loop.cu",
        replaces=mkpy + "608", launches=lp["launches"],
        max_abs_err=max([lp["err"]] + record["k7_check_err"]),
        ms=lp["ms"], plain_ms=lp["plain"], bound_ms=lp["bound"],
        bound_by=lp["by"], plain_lanes=lp["plain_lanes"],
        ms_plain_lanes=lp["ms_plain_lanes"],
        lanes_per_frame=lp["lanes_per_frame"],
        k2_mask_ms=record["k2_loop_ms"],
        smem_check_ms=record["k7_smem"][0],
        smem_check_bound_ms=record["k7_smem"][1],
        ldg_check_ms=record["k7_ldg"][0],
        ldg_check_bound_ms=record["k7_ldg"][1], **common))
    rows.append(dict(
        name="K1-ext bounce body (in K1, K3+K4, K7)",
        source=src + "bounce.cuh", replaces=mkpy + "1921",
        launches=t["launches"],
        max_abs_err=max([t["err"], sm["err"]] + record["k1ext_check_err"]),
        ms=t["ms"], plain_ms=t["plain"], bound_ms=t["bound"],
        bound_by=t["by"], plain_lanes=t["plain_lanes"],
        ms_plain_lanes=t["ms_plain_lanes"],
        lanes_per_frame=t["lanes_per_frame"],
        bvh_vn_ms=sm["ms"], bvh_vn_launches=sm["launches"],
        bvh_vn_bound_ms=sm["bound"], bvh_vn_plain_ms=sm["plain"],
        bvh_vn_plain_lanes=sm["plain_lanes"],
        bvh_vn_lanes_per_frame=sm["lanes_per_frame"], **common))
    return rows


def kernel_rows(mk, trace_mod, scene, ring, cfg, launches, launches_bvh,
                record):
    """Each kernel at its bench frame: checks, times, bounds; the rows of
    the JSON kernel record."""
    import torch
    dev = torch.device("cuda")
    n_px = W * H
    rows = []

    # K2 at the bench frame
    g = scene.geometry
    nbs = g.sph_center.shape[0] + g.tri_v0.shape[0]
    npl = g.pl_point.shape[0]
    _, k2_launch = mk.prepare_pixel_mask(scene, width=W, height=H, cfg=cfg)
    k2_ms = cuda_ms(k2_launch, 20)
    k2_plain = cuda_ms(lambda: mk.pixel_mask_plain(
        scene, width=W, height=H, cfg=cfg), 3)
    k2_bound, k2_by = bound(n_px * (27 + 28 * nbs + 23 * npl),
                            n_px + 4 * (13 + 4 * nbs + 7 * npl))

    # K1 at the bench lanes (100 spp over the hit pixels), per launch of
    # the main path's chunks
    px, o, d, pix, samp, sizes = lanes_of(scene, W, H, SPP, cfg, chunks=True)
    n_k1 = len(sizes)
    cnt = torch.zeros((o.shape[0], mk.COUNTERS), dtype=torch.int32,
                      device=dev)
    k1_out, k1_counted = chunk_launches(mk, scene, (o, d, pix, samp), sizes,
                                       cfg, counters=cnt)
    k1_counted()
    got = k1_out()
    _, k1_launch = chunk_launches(mk, scene, (o, d, pix, samp), sizes, cfg)
    k1_ms = cuda_ms(k1_launch, 5) / n_k1
    k1_plain, want = host_ms(lambda: trace_mod.trace(scene, o, d, pix, samp,
                                                     cfg))
    k1_err = float((got - want).abs().max())
    image_gate(pixel_image(px, got, W, H, SPP),
               pixel_image(px, want, W, H, SPP),
               f"K1 at the bench lanes (max lane error {k1_err:.3e})")
    ops, work = k1_ops(scene, cnt)
    k1_bound, k1_by = bound(ops / n_k1,
                            o.shape[0] / n_k1 * (12 + 12 + 4 + 4 + 12))
    print(f"   K1: {o.shape[0]} lanes in {n_k1} launch(es), work [closest, "
          f"hard, soft, sphere/plane tests, tri/box tests] = {work}, "
          f"{ops:.4e} ops; per launch {k1_ms:.4f} ms, bound "
          f"{k1_bound:.4f} ms; plain over all lanes {k1_plain:.1f} ms",
          flush=True)
    print(f"   K2: {n_px} pixels x {nbs} bounding spheres; {k2_ms:.4f} ms "
          f"vs plain {k2_plain:.4f} ms, bound {k2_bound:.6f} ms", flush=True)
    del px, o, d, pix, samp, cnt, got, want

    # K6 at the bvh bench frame
    mwork = [0, 0]
    mk.pixel_mask_plain(ring, width=W, height=H, cfg=cfg, work=mwork)
    _, k6_launch = mk.prepare_pixel_mask(ring, width=W, height=H, cfg=cfg)
    k6_ms = cuda_ms(k6_launch, 20)
    k6_plain = cuda_ms(lambda: mk.pixel_mask_plain(
        ring, width=W, height=H, cfg=cfg), 3)
    rg = ring.geometry
    nbs_r = rg.sph_center.shape[0] + rg.tri_v0.shape[0]
    n_nodes = ring.accel.n_nodes
    k6_bound, k6_by = bound(
        n_px * (27 + 23 * rg.pl_point.shape[0]) + mwork[0] * 21
        + mwork[1] * 28,
        n_px + 4 * (13 + 4 * nbs_r + 9 * n_nodes + nbs_r))
    print(f"   K6: {n_px} pixels, {n_nodes} nodes, work [slab tests, "
          f"bounding-sphere tests] = {mwork}; {k6_ms:.4f} ms vs plain "
          f"{k6_plain:.4f} ms, bound {k6_bound:.6f} ms", flush=True)

    # K3+K4 at the bvh bench lanes, per launch of the main path's chunks
    px, o, d, pix, samp, sizes = lanes_of(ring, W, H, SPP, cfg, chunks=True)
    lanes = (o, d, pix, samp)
    n, n_k3 = o.shape[0], len(sizes)
    idx = torch.arange(0, n, max(1, n // K3_SUBSET), device=dev)
    so, sd, spix, ssamp = o[idx], d[idx], pix[idx], samp[idx]
    k3_out, k3_launch = chunk_launches(mk, ring, lanes, sizes, cfg)
    k3_launch()
    sub_k, sub_launch = mk.prepare_trace(ring, so, sd, spix, ssamp, cfg)
    sub_ms = cuda_ms(sub_launch, 1)
    if not torch.equal(k3_out()[idx], sub_k):
        raise AssertionError("K3: the main-path launches and the subset "
                             "launch disagree at the same lanes")
    plain_ms, want = host_ms(lambda: trace_mod.trace(
        ring, so, sd, spix, ssamp, cfg))
    k3_err = float((sub_k - want).abs().max())
    image_gate(sub_k, want, f"K3+K4 at {idx.numel()} of the bvh bench lanes "
               f"(one lane a pixel; max lane error {k3_err:.3e})")
    hard_cfg = trace_mod.TraceConfig(max_depth=DEPTH, shadow_samples=SOFT,
                                     seed=0, soft_shadows=False)
    plain_hard_ms, _ = host_ms(lambda: trace_mod.trace(
        ring, so, sd, spix, ssamp, hard_cfg))
    k3_ms = cuda_ms(k3_launch, 2) / n_k3
    _, hard_launch = chunk_launches(mk, ring, lanes, sizes, hard_cfg)
    hard_ms = cuda_ms(hard_launch, 2) / n_k3
    cnt = torch.zeros((n, mk.BVH_COUNTERS), dtype=torch.int32, device=dev)
    _, counted = chunk_launches(mk, ring, lanes, sizes, cfg, counters=cnt)
    counted()
    ops, k4_ops, work = k3_ops(cnt)
    k3_bound, k3_by = bound(ops / n_k3, n / n_k3 * (12 + 12 + 4 + 4 + 12))
    k4_bound, k4_by = bound(k4_ops / n_k3, 0)
    print(f"   K3+K4: {n} lanes in {n_k3} launches, work [closest, hard, "
          f"soft, slab, sphere, triangle, fused slab, fused (ray, sphere), "
          f"fused (ray, triangle), plane/box] = {work}, {ops:.4e} ops of "
          f"which K4 {k4_ops:.4e}; per launch {k3_ms:.4f} ms, without soft "
          f"shadows {hard_ms:.4f} ms (K4 {k3_ms - hard_ms:.4f} ms); bound "
          f"per launch {k3_bound:.4f} ms (K4 {k4_bound:.4f} ms)", flush=True)
    print(f"   K3+K4 on {idx.numel()} lanes: {sub_ms:.3f} ms vs plain "
          f"{plain_ms:.1f} ms (plain without soft shadows "
          f"{plain_hard_ms:.1f} ms)", flush=True)

    if (launches["trace_unroll"], launches_bvh["trace_bvh"]) != (n_k1, n_k3):
        raise AssertionError(f"the main path's trace launches "
                             f"{launches['trace_unroll']}, "
                             f"{launches_bvh['trace_bvh']} are not its "
                             f"chunk counts {n_k1}, {n_k3}")

    def row(name, source, replaces, n_launch, err, ms, plain, bnd, by,
            **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=n_launch, max_abs_err=err,
                    ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                    library_ms=None, **extra)

    src = "raytrace_tpu_torch/csrc/"
    mkpy = "raytrace_tpu/ops/megakernel.py:"
    subset = dict(plain_lanes=int(idx.numel()), ms_plain_lanes=sub_ms,
                  lanes_per_frame=n)
    rows += [
        row("K1 trace_unroll", src + "trace_unroll.cu", mkpy + "2987",
            launches["trace_unroll"], k1_err, k1_ms, k1_plain, k1_bound,
            k1_by),
        row("K2 pixel_mask", src + "pixel_mask.cu", mkpy + "2532",
            launches["pixel_mask"], record["k2_err"], k2_ms, k2_plain,
            k2_bound, k2_by),
        row("K3 trace_bvh", src + "trace_bvh.cu", mkpy + "954",
            launches_bvh["trace_bvh"], k3_err, k3_ms, plain_ms, k3_bound,
            k3_by, **subset),
        row("K4 trace_bvh soft walk", src + "bvh_walk.cuh", mkpy + "1308",
            launches_bvh["trace_bvh"], k3_err, k3_ms - hard_ms,
            plain_ms - plain_hard_ms, k4_bound, k4_by, **subset),
        row("K6 pixel_mask_bvh", src + "pixel_mask.cu", mkpy + "2661",
            launches_bvh["pixel_mask_bvh"], record["k6_err"], k6_ms,
            k6_plain, k6_bound, k6_by),
    ]
    return rows


if __name__ == "__main__":
    sys.exit(main())
