#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
the port builds, runs and agrees with itself on the card.

    python3 chip_smoke.py

Phases, in order (each prints a line before and after, with its seconds):

  env           card name and power limit, torch and CUDA versions
  build         one nvcc call for both kernels; registers, shared memory
                and spills from -Xptxas -v
  k2_check      K2 (pixel mask) against its plain version at 800x600 on
                the three demo scenes: the masks must be equal
  k1_check      K1 (bounce megakernel) against its plain version on the
                lanes of a 64x48 frame, 4 spp, depth 50, three scenes,
                under the image gate
  render_check  the main path (K2, compaction, K1) against the dense plain
                path at 800x600, 4 spp, depth 50 on the bench scene, under
                the image gate
  bench         Renderer().render of the bench workload (800x600, 100 spp,
                depth 50, 16 soft-shadow rays, seed 0): one warm-up, then
                3 timed frames; launch counts are reset just before the
                first timed frame and read just after it
  kernels       K1 against its plain version on the bench frame's own
                lanes, under the image gate; each kernel's time at the
                bench shapes (CUDA events) beside its plain version's and
                its bound

The image gate is the goldens gate of tests/test_goldens.py: at most 0.1%
of pixels off by more than 1e-3 and a mean absolute error below 1e-4.

The bench scene is assets/sphere_reflections_light.json with the camera
mirrored to +Z (the shipped -Z position faces away from the geometry
under the reference camera). The last two lines of output are the JSON
kernel record and the contract line. Any failure raises and exits non-zero
with no contract line; without a GPU the script exits non-zero at once.
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


def lanes_of(scene, width, height, samples, cfg):
    """K1's input on the main path: the compacted pixels and the rays of
    their lanes, read from render_wavefront through its stage hook."""
    from raytrace_tpu_torch import renderer as r
    seen = []

    def hook(stage, **values):
        if stage == "lane_rays":
            seen.append(values)

    r.render_wavefront(scene, width=width, height=height, samples=samples,
                       cfg=cfg, hook=hook)
    if len(seen) != 1:
        raise AssertionError(f"{len(seen)} trace chunks, expected one")
    v = seen[0]
    return (v["px"], v["origin"].contiguous(), v["direction"].contiguous(),
            v["pix"], v["samp"])


def pixel_image(px, rad, width, height, samples):
    import torch
    img = torch.zeros((width * height, 3), device=rad.device)
    img.index_add_(0, px, rad.reshape(-1, samples, 3).sum(dim=1))
    return (img / samples).reshape(height, width, 3)


def frame_stages(r, scene):
    """Milliseconds of each stage of one bench frame: render_wavefront,
    timed through its stage hook, then tonemap and the copy to the host.
    Each stage is ended by a synchronise, so the sum exceeds a frame."""
    import torch
    from raytrace_tpu_torch import renderer as rmod
    from raytrace_tpu_torch.ops import tonemap
    ms = {}
    last = [time.perf_counter()]

    def mark(stage, **values):
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[stage] = ms.get(stage, 0.0) + (now - last[0]) * 1e3
        last[0] = now

    img = rmod.render_wavefront(scene, width=W, height=H, samples=SPP,
                                cfg=r.trace_config(), hook=mark)
    tonemap.tonemap_rgb8(img).cpu()
    mark("tonemap_copy")
    return {k: round(v, 3) for k, v in ms.items()}


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
            got = mk.trace_unroll(s, o, d, pix, samp, cfg)
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

    with Phase("bench"):
        r = rmod.Renderer(device=dev)
        r.set_samples(SPP)
        r.set_max_depth(DEPTH)
        scene = scenes[SCENES[0]]
        r.render(scene, W, H)  # warm-up
        times = []
        for i in range(3):
            if i == 0:
                mk.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = r.render(scene, W, H)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                launches = dict(mk.LAUNCHES)
        for k, n in launches.items():
            if n < 1:
                raise AssertionError(f"the main path never launched {k}")
        if img.shape != (H, W, 3) or str(img.dtype) != "uint8":
            raise AssertionError(f"bad image {img.shape} {img.dtype}")
        nonblack = float((img.sum(axis=2) > 0).mean())
        if nonblack <= 0.0:
            raise AssertionError("the bench frame is black")
        with tempfile.TemporaryDirectory() as tmp:
            r.save_image(img, os.path.join(tmp, "bench.png"))
        best = sorted(times)[1]
        print(f"   stages of one frame, ms (host clock, synchronised): "
              f"{frame_stages(r, scene)}", flush=True)
        print(f"   frame seconds {[round(t, 4) for t in times]}; median "
              f"{best:.4f} s = {W * H * SPP / best:.4e} camera samples/s; "
              f"non-black {nonblack:.4f}; launches {launches}", flush=True)

    with Phase("kernels"):
        scene = scenes[SCENES[0]]
        n_px = W * H
        # K2 at the bench frame
        g = scene.geometry
        nbs = g.sph_center.shape[0] + g.tri_v0.shape[0]
        npl = g.pl_point.shape[0]
        _, k2_launch = mk.prepare_pixel_mask(scene, width=W, height=H,
                                             cfg=cfg)
        k2_ms = cuda_ms(k2_launch, 20)
        k2_plain = cuda_ms(lambda: mk.pixel_mask_plain(
            scene, width=W, height=H, cfg=cfg), 3)
        k2_ops = n_px * (27 + 28 * nbs + 23 * npl)
        k2_bytes = n_px + 4 * (13 + 4 * nbs + 7 * npl)
        k2_bound = max(k2_bytes / HBM_BYTES_PER_S,
                       k2_ops / FP32_OPS_PER_S) * 1e3
        # K1 at the bench lanes (100 spp over the hit pixels)
        px, o, d, pix, samp = lanes_of(scene, W, H, SPP, cfg)
        cnt = torch.zeros((o.shape[0], mk.COUNTERS), dtype=torch.int32,
                          device=dev)
        got, k1_counted = mk.prepare_trace_unroll(scene, o, d, pix, samp,
                                                  cfg, counters=cnt)
        k1_counted()
        _, k1_launch = mk.prepare_trace_unroll(scene, o, d, pix, samp, cfg)
        k1_ms = cuda_ms(k1_launch, 5)
        t0 = time.perf_counter()
        want = trace_mod.trace(scene, o, d, pix, samp, cfg)
        torch.cuda.synchronize()
        k1_plain = (time.perf_counter() - t0) * 1e3
        k1_err = float((got - want).abs().max())
        image_gate(pixel_image(px, got, W, H, SPP),
                   pixel_image(px, want, W, H, SPP),
                   f"K1 at the bench lanes (max lane error {k1_err:.3e})")
        ops, work = k1_ops(scene, cnt)
        k1_bytes = o.shape[0] * (12 + 12 + 4 + 4 + 12)
        k1_bound = max(k1_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        print(f"   K1: {o.shape[0]} lanes, work [closest, hard, soft, "
              f"sphere/plane tests, tri/box tests] = {work}, {ops:.4e} ops; "
              f"{k1_ms:.4f} ms vs plain {k1_plain:.1f} ms, bound "
              f"{k1_bound:.4f} ms", flush=True)
        print(f"   K2: {n_px} pixels x {nbs} bounding spheres; {k2_ms:.4f} ms "
              f"vs plain {k2_plain:.4f} ms, bound {k2_bound:.6f} ms",
              flush=True)
        kernels = [
            dict(name="K1 trace_unroll", route="cuda",
                 source="raytrace_tpu_torch/csrc/trace_unroll.cu",
                 replaces="raytrace_tpu/ops/megakernel.py:2987",
                 launches=launches["trace_unroll"], max_abs_err=k1_err,
                 ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound,
                 bound_by=("operations" if ops / FP32_OPS_PER_S
                           >= k1_bytes / HBM_BYTES_PER_S else "bytes"),
                 library_ms=None),
            dict(name="K2 pixel_mask", route="cuda",
                 source="raytrace_tpu_torch/csrc/pixel_mask.cu",
                 replaces="raytrace_tpu/ops/megakernel.py:2532",
                 launches=launches["pixel_mask"],
                 max_abs_err=record["k2_err"], ms=k2_ms, plain_ms=k2_plain,
                 bound_ms=k2_bound,
                 bound_by=("operations" if k2_ops / FP32_OPS_PER_S
                           >= k2_bytes / HBM_BYTES_PER_S else "bytes"),
                 library_ms=None),
        ]

    print(gpu_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
