"""The trace kernel of a mode per launch on the card, with its shadow
loops split apart, for one or more builds in one process: K5 (stream
mode), K3+K4 (bvh mode), K1 (unroll mode) or K7 (loop mode).

    python -m raytrace_tpu_torch.tools.measure_stream_walk \
        [--mode stream|bvh|unroll|loop] [--pkg LABEL=DIR ...] \
        [--in-place] [--unguarded] [--reps N] [--out FILE]

For each bench frame of the mode (at 800x600, 100 spp, depth 50, 16
soft-shadow rays, seed 0, as ``chip_smoke.py`` renders them: stream mode
grid-5833 and ico-10241; bvh mode ring-1000, smooth_shading_demo with its
look-at camera, and ico-2561, two smooth icospheres of 1,280 triangles
over a plane; unroll mode the bench scene, textured_mirror_demo and
final_silver_prism_purple_cube, the last two with their look-at camera
and their scene config's renderer block; loop mode the
mesh_smooth_icosphere golden and a ring of 2,500 spheres, both without a
BVH, the ring at 4 spp: 1.92M lanes, where the parent's K7 took seconds
a launch) it captures the main path's lanes (the trace chunks and, in stream
mode, the split ladder's segments, through ``render_wavefront``'s hook)
once, then times with CUDA events the kernel's launch over every chunk
(and the ladder's segment launches) under three settings: soft shadows
on, soft shadows off, and the scene without lights (no shadow test at
all). A lane's path does not depend on its direct light, so the same
inputs serve all three, and the differences split the kernel's time into
the closest-hit tests, the hard shadows and the soft shadows.

Builds: this package's library ("this"); in bvh and loop modes with
``--in-place`` also this build reading its table in place from global
memory ("this-inplace": ``megakernel.BVH_SMEM_BYTES`` or
``LOOP_SMEM_BYTES`` set to 0); in unroll and loop modes with
``--unguarded`` also this build without K1-guard ("this-unguarded").
Each ``--pkg`` directory holds another copy of ``raytrace_tpu_torch`` (a
parent commit's, or a variant of this one) with this build's C launchers
(the mode's ``rt_trace_*`` entry takes the same arguments), built by that
copy's own ``_build`` in parallel. The builds are timed in turns (ABBA)
and must give equal radiance and equal per-lane work counters (a build
without K1-guard: equal radiance and equal ray counts).
Prints a JSON summary (also written to ``--out``) with the card's name
and power limit and each build's registers, stack, spills and the bytes
of each frame's table. Needs a CUDA GPU.

A parent commit's package for ``--pkg``: ``git archive HEAD~1
raytrace_tpu_torch | tar -x -C _ab/parent`` in a checkout (into a
git-ignored directory), then ``--pkg parent=_ab/parent``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import torch

from .. import renderer as rmod
from .. import scene as scene_mod
from .. import trace as trace_mod
from ..bench import suite
from ..ops import _build
from ..ops import megakernel as mk
from .measure_dma_stream import card

W, H, SPP, DEPTH, SOFT = 800, 600, 100, 50, 16
RING_SPP = 4   # the ring-2500 loop frame's samples a pixel
MAX_RUNS = 256  # runs of a launch list in one timing (cuda_ms)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENTRIES = {mode: (f"rt_{kernel}_kernel", f"rt_{kernel}_state_kernel")
           for mode, kernel in mk.KERNELS.items()}


def bench_dict():
    with open(os.path.join(REPO, "assets",
                           "sphere_reflections_light.json")) as f:
        d = json.load(f)
    d["camera"]["position"][2] = -d["camera"]["position"][2]
    return d


def frames(mode, tmp):
    """{name: (scene dict or asset path, go camera, built with a BVH)} of
    a mode's frames."""
    asset = lambda name: os.path.join(REPO, "assets", f"{name}.json")
    if mode == "stream":
        return {"grid-5833": (suite.grid_scene_dict(), True, None),
                "ico-10241": (suite.mesh_scene_dict(tmp), True, None)}
    if mode == "unroll":
        return {"bench": (bench_dict(), True, None),
                "textured": (asset("textured_mirror_demo"), False, None),
                "final_silver": (asset("final_silver_prism_purple_cube"),
                                 False, None)}
    if mode == "loop":
        return {"loop": (suite.golden_scene_dict("mesh_smooth_icosphere")[0],
                         True, False),
                "ring-2500": (suite.ring_scene_dict(2500), True, False,
                              RING_SPP)}
    return {"ring-1000": (suite.ring_scene_dict(1000), True, None),
            "smooth": (asset("smooth_shading_demo"), False, None),
            "ico-2561": (suite.mesh_scene_dict(tmp, subdiv=3), True, None)}


def load(src, dev, build_accel=None, samples=SPP):
    """(scene, the trace settings of its frame, its samples a pixel): an
    asset with its scene config's renderer block (samples, depth)
    applied."""
    cfg = trace_mod.TraceConfig(max_depth=DEPTH, shadow_samples=SOFT, seed=0)
    if isinstance(src, str):
        scene, scfg = scene_mod.load(src, device=dev)
        r = rmod.Renderer(device=dev)
        r.set_samples(SPP)
        r._apply_renderer_block(scfg)
        cfg = dataclasses.replace(r.trace_config(), shadow_samples=SOFT)
        return scene, cfg, r.samples
    return (scene_mod.from_dict(src, device=dev, build_accel=build_accel)[0],
            cfg, samples)


def _build_in(pkg_dir: str) -> subprocess.Popen:
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from raytrace_tpu_torch.ops import _build; r = _build.build(); "
            "print(json.dumps([r.path, r.ptxas]))")
    return subprocess.Popen([sys.executable, "-c", code, pkg_dir],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


class _Entry:
    """A stand-in for ``_build.library()`` holding launcher functions of
    another build (the same C signatures as this build's)."""

    def __init__(self, **fns):
        self.__dict__.update(fns)


@dataclasses.dataclass
class Build:
    library: object    # the _build.library() stand-in, None for this one's
    kw: dict           # more arguments of prepare_trace
    path: str
    regs: dict
    budget: int = mk.BVH_SMEM_BYTES       # megakernel.BVH_SMEM_BYTES,
    loop_budget: int = mk.LOOP_SMEM_BYTES  # and LOOP_SMEM_BYTES, for them
    guarded: bool = True  # its K1 and K7 run K1-guard (the counters' sense)


def _bind(path, name, like):
    fn = getattr(ctypes.CDLL(path), name)
    fn.argtypes = like.argtypes
    fn.restype = like.restype
    return fn


def builds(mode, pkgs, in_place=False, unguarded=False):
    """{label: Build}."""
    procs = {label: _build_in(d) for label, d in pkgs}
    res = _build.build()
    own = _build.library()
    regs = _build.kernel_resources(res.ptxas)
    out = {"this": Build(None, {}, res.path, regs)}
    if in_place and mode in ("bvh", "loop"):
        out["this-inplace"] = Build(None, {}, res.path, regs, 0, 0)
    if unguarded and mode in ("unroll", "loop"):
        out["this-unguarded"] = Build(None, {"soft_guard": False}, res.path,
                                      regs, guarded=False)
    name = "rt_" + mk.KERNELS[mode]
    for label, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"build of {label} failed:\n{stderr}")
        path, ptxas = json.loads(stdout.strip().splitlines()[-1])
        fn = _bind(path, name, getattr(own, name))
        out[label] = Build(_Entry(**{name: fn}), {}, path,
                           _build.kernel_resources(ptxas))
    return out


@contextlib.contextmanager
def using(build):
    """Within the block, prepare_trace launches ``build``'s kernel."""
    real = _build.library, mk.BVH_SMEM_BYTES, mk.LOOP_SMEM_BYTES
    if build.library is not None:
        _build.library = lambda: build.library
    mk.BVH_SMEM_BYTES, mk.LOOP_SMEM_BYTES = build.budget, build.loop_budget
    try:
        yield
    finally:
        _build.library, mk.BVH_SMEM_BYTES, mk.LOOP_SMEM_BYTES = real


def without_lights(scene):
    dev = scene.device
    return dataclasses.replace(scene, lights=scene_mod.Lights(
        position=torch.zeros((0, 3), device=dev),
        color=torch.zeros((0, 3), device=dev),
        intensity=torch.zeros((0,), device=dev)))


def capture(scene, cfg, samples, go_camera=True):
    """The main path's trace chunks and ladder segments of one frame."""
    chunks, segs = [], []

    def hook(stage, **values):
        if stage == "lane_rays":
            chunks.append({k: values[k] for k in
                           ("origin", "direction", "pix", "samp")})
        elif stage == "segment":
            segs.append(values)

    # the first frame of its key: one pass (a frame at the capacity of
    # another scene may be rendered twice)
    rmod._KPAD_CACHE.pop(rmod.capacity_key(W, H, samples, cfg, go_camera,
                                           None, scene.device), None)
    rmod.render_wavefront(scene, width=W, height=H, samples=samples,
                          cfg=cfg, go_camera=go_camera, hook=hook)
    return chunks, segs


def launches(scene, cfg, chunks, segs, counters=False, **kw):
    """(unsplit launch functions and outputs, segment launch functions);
    ``kw``: more arguments of prepare_trace."""
    unsplit, outs, cnts = [], [], []
    n_cnt = (mk.BVH_COUNTERS if mk._kernel_mode(scene) in ("bvh", "stream")
             else mk.COUNTERS)
    for c in chunks:
        cnt = None
        if counters:
            cnt = torch.zeros((c["origin"].shape[0], n_cnt),
                              dtype=torch.int32, device=c["origin"].device)
            cnts.append(cnt)
        out, f = mk.prepare_trace(scene, c["origin"], c["direction"],
                                  c["pix"], c["samp"], cfg, counters=cnt,
                                  **kw)
        unsplit.append(f)
        outs.append(out)
    seg_fns = []
    for v in segs:
        last = v["b1"] >= cfg.max_depth
        kws = dict(start_bounce=v["b0"], return_state=not last,
                   end_bounce=None if last else v["b1"], **kw)
        if v["b0"] > 0:
            kws.update(init_throughput=v["throughput"], init_alive=v["alive"])
        seg_fns.append(mk.prepare_trace(scene, v["origin"], v["direction"],
                                        v["pix"], v["samp"], cfg, **kws)[1])
    return unsplit, outs, cnts, seg_fns


def cuda_ms(fns, min_ms=20.0):
    """ms of one run of the launches ``fns``, timed with CUDA events over
    as many runs back to back as fill ``min_ms`` (one launch of a small
    frame takes half a millisecond, and the host's launch work before its
    first kernel would count in a single run)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = 1
    while True:
        torch.cuda.synchronize()
        start.record()
        for _ in range(runs):
            for f in fns:
                f()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if ms >= min_ms or runs >= MAX_RUNS or not fns:
            return ms / runs
        runs = min(MAX_RUNS, max(2 * runs,
                                 int(runs * min_ms / max(ms, 1e-3)) + 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=tuple(mk.KERNELS), default="stream")
    ap.add_argument("--pkg", action="append", default=[],
                    help="LABEL=DIR: a directory holding another copy of "
                         "raytrace_tpu_torch")
    ap.add_argument("--in-place", action="store_true",
                    help="bvh and loop modes: also time this build reading "
                         "its table in place")
    ap.add_argument("--unguarded", action="store_true",
                    help="unroll and loop modes: also time this build "
                         "without K1-guard")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_stream_walk: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    pkgs = [tuple(p.split("=", 1)) for p in args.pkg]
    blds = builds(args.mode, pkgs, args.in_place, args.unguarded)
    labels = list(blds)
    report = {"card": card(), "mode": args.mode, "builds": {}, "frames": {}}
    for label, b in blds.items():
        report["builds"][label] = {
            "library": os.path.basename(b.path), "smem_budget": b.budget,
            "loop_smem_budget": b.loop_budget, "guarded": b.guarded,
            "kw": b.kw, "resources": {e: b.regs.get(e)
                                      for e in ENTRIES[args.mode]
                                      if e in b.regs}}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for frame, (src, go, accel, *spp) in frames(args.mode, tmp).items():
            scene, soft_cfg, samples = load(src, dev, accel, *spp)
            cfgs = {"soft": soft_cfg,
                    "hard": dataclasses.replace(soft_cfg,
                                                soft_shadows=False),
                    "none": soft_cfg}
            if mk._kernel_mode(scene) != args.mode:
                raise AssertionError(f"{frame} is not a {args.mode}-mode "
                                     "scene")
            chunks, segs = capture(scene, soft_cfg, samples, go)
            if args.mode != "stream":
                segs = []   # unsplit: one segment a chunk, its launch
            dark = without_lights(scene)
            rec = {"chunks": len(chunks), "segments": len(segs),
                   "lanes": sum(c["origin"].shape[0] for c in chunks),
                   "segment_lanes": sum(v["origin"].shape[0] for v in segs),
                   "samples": samples, "max_depth": soft_cfg.max_depth,
                   "smem_bytes": mk.trace_smem_bytes(scene), "ms": {}}
            ref = None
            for label in labels:
                with using(blds[label]):
                    run, outs, cnts, _ = launches(scene, cfgs["soft"],
                                                  chunks, [], counters=True,
                                                  **blds[label].kw)
                    for f in run:
                        f()
                    rad = torch.cat(outs)
                    cnt = torch.cat(cnts)
                work = [int(x) for x in cnt.to(torch.int64).sum(0)]
                rec.setdefault("work", {})[label] = work
                if ref is None:
                    ref = (rad, cnt)
                else:
                    # without the guard the ray counts stay, the tests move
                    cols = (cnt.shape[1] if blds[label].guarded
                            == blds[labels[0]].guarded else 3)
                    same = (torch.equal(rad, ref[0]),
                            torch.equal(cnt[:, :cols], ref[1][:, :cols]))
                    rec.setdefault("equal_to_" + labels[0], {})[label] = same
                    ok = ok and all(same)
                del outs, cnts, rad, cnt
            del ref
            for rep in range(args.reps):
                order = labels if rep % 2 == 0 else labels[::-1]
                for label in order:
                    b = blds[label]
                    with using(b):
                        for name, cfg in cfgs.items():
                            s = dark if name == "none" else scene
                            unsplit, _, _, seg_fns = launches(
                                s, cfg, chunks, segs, **b.kw)
                            for f in unsplit[:1]:
                                f()  # warm-up
                            t_u = cuda_ms(unsplit)
                            t_l = cuda_ms(seg_fns) if seg_fns else 0.0
                            del unsplit, seg_fns
                            m = rec["ms"].setdefault(label, {}).setdefault(
                                name, {"unsplit": [], "ladder": []})
                            m["unsplit"].append(t_u)
                            m["ladder"].append(t_l)
                    print(f"{frame} rep {rep} {label}: " + ", ".join(
                        f"{n} unsplit {v['unsplit'][-1]:.1f} ladder "
                        f"{v['ladder'][-1]:.1f} ms"
                        for n, v in rec["ms"][label].items()), flush=True)
            report["frames"][frame] = rec
            del chunks, segs, scene, dark
            torch.cuda.empty_cache()
    report["equal"] = ok
    text = json.dumps(report)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
