"""The trace kernel of a tree mode per launch on the card, with its shadow
walks split apart, for one or more builds in one process: K5 (stream
mode) or K3+K4 (bvh mode).

    python -m raytrace_tpu_torch.tools.measure_stream_walk \
        [--mode stream|bvh] [--pkg LABEL=DIR ...] [--serial] \
        [--in-place] [--reps N] [--out FILE]

For each bench frame of the mode (``chip_smoke.py``'s, at 800x600, 100
spp, depth 50, 16 soft-shadow rays, seed 0: stream mode grid-5833 and
ico-10241; bvh mode ring-1000, smooth_shading_demo with its look-at
camera, and ico-2561, two smooth icospheres of 1,280 triangles over a
plane) it captures the main path's lanes (the trace chunks and, in stream
mode, the split ladder's segments, through ``render_wavefront``'s hook)
once, then times with CUDA events the kernel's launch over every chunk
(and the ladder's segment launches) under three settings: soft shadows
on, soft shadows off, and the scene without lights (no shadow walk at
all). A lane's path does not depend on its direct light, so the same
inputs serve all three, and the differences split the kernel's time into
the closest-hit walk, the hard-shadow walk and the fused soft walk.

Builds: this package's library ("this"). In stream mode, with
``--serial``, also its per-thread leaf walk (``rt_trace_stream_serial``,
"this-serial"). In bvh mode also the previous K3+K4 ("this-global",
``rt_trace_bvh_global``), and with ``--in-place`` this build's K3+K4
reading its walk table in place from global memory ("this-inplace",
``megakernel.BVH_SMEM_BYTES`` set to 0). Each
``--pkg`` directory holds another copy of ``raytrace_tpu_torch`` (a
parent commit's, or a variant of this one), built by that copy's own
``_build`` in parallel; in bvh mode a copy
without ``rt_trace_bvh_global`` (a parent from before the walk table)
runs its ``rt_trace_bvh`` in the previous design's place. The builds are
timed in turns (ABBA) and must give equal radiance and equal per-lane work
counters. Prints a JSON summary (also written to ``--out``) with the
card's name and power limit and each build's registers, stack, spills
and, in bvh mode, the walk table's bytes. Needs a CUDA GPU.
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
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENTRIES = {"stream": ("rt_trace_stream_kernel",
                      "rt_trace_stream_state_kernel",
                      "rt_trace_stream_serial_kernel",
                      "rt_trace_stream_serial_state_kernel"),
           "bvh": ("rt_trace_bvh_kernel", "rt_trace_bvh_state_kernel",
                   "rt_trace_bvh_global_kernel",
                   "rt_trace_bvh_global_state_kernel")}


def frames(mode, tmp):
    """{name: (scene dict or asset path, go camera)} of a mode's frames."""
    if mode == "stream":
        return {"grid-5833": (suite.grid_scene_dict(), True),
                "ico-10241": (suite.mesh_scene_dict(tmp), True)}
    return {"ring-1000": (suite.ring_scene_dict(1000), True),
            "smooth": (os.path.join(REPO, "assets",
                                    "smooth_shading_demo.json"), False),
            "ico-2561": (suite.mesh_scene_dict(tmp, subdiv=3), True)}


def load(src, dev):
    if isinstance(src, str):
        return scene_mod.load(src, device=dev)[0]
    return scene_mod.from_dict(src, device=dev)[0]


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
    budget: int = mk.BVH_SMEM_BYTES  # megakernel.BVH_SMEM_BYTES for them


def _bind(path, name, like):
    fn = getattr(ctypes.CDLL(path), name)
    fn.argtypes = like.argtypes
    fn.restype = like.restype
    return fn


def builds(mode, pkgs, serial, in_place=False):
    """{label: Build}."""
    procs = {label: _build_in(d) for label, d in pkgs}
    res = _build.build()
    own = _build.library()
    regs = _build.kernel_resources(res.ptxas)
    out = {"this": Build(None, {}, res.path, regs)}
    if mode == "stream" and serial:
        out["this-serial"] = Build(None, {"leaf_group": False}, res.path,
                                   regs)
    if mode == "bvh":
        out["this-global"] = Build(None, {"bvh_smem": False}, res.path, regs)
        if in_place:
            out["this-inplace"] = Build(None, {}, res.path, regs, 0)
    for label, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"build of {label} failed:\n{stderr}")
        path, ptxas = json.loads(stdout.strip().splitlines()[-1])
        r = _build.kernel_resources(ptxas)
        if mode == "stream":
            lib = _Entry(rt_trace_stream=_bind(path, "rt_trace_stream",
                                               own.rt_trace_stream))
            out[label] = Build(lib, {}, path, r)
        elif hasattr(ctypes.CDLL(path), "rt_trace_bvh_global"):
            lib = _Entry(rt_trace_bvh=_bind(path, "rt_trace_bvh",
                                            own.rt_trace_bvh))
            out[label] = Build(lib, {}, path, r)
        else:   # the previous design's entry under its old name
            lib = _Entry(rt_trace_bvh_global=_bind(
                path, "rt_trace_bvh", own.rt_trace_bvh_global))
            out[label] = Build(lib, {"bvh_smem": False}, path, r)
    return out


@contextlib.contextmanager
def using(build):
    """Within the block, prepare_trace launches ``build``'s kernel."""
    real, budget = _build.library, mk.BVH_SMEM_BYTES
    if build.library is not None:
        _build.library = lambda: build.library
    mk.BVH_SMEM_BYTES = build.budget
    try:
        yield
    finally:
        _build.library, mk.BVH_SMEM_BYTES = real, budget


def without_lights(scene):
    dev = scene.device
    return dataclasses.replace(scene, lights=scene_mod.Lights(
        position=torch.zeros((0, 3), device=dev),
        color=torch.zeros((0, 3), device=dev),
        intensity=torch.zeros((0,), device=dev)))


def capture(scene, cfg, go_camera=True):
    """The main path's trace chunks and ladder segments of one frame."""
    chunks, segs = [], []

    def hook(stage, **values):
        if stage == "lane_rays":
            chunks.append({k: values[k] for k in
                           ("origin", "direction", "pix", "samp")})
        elif stage == "segment":
            segs.append(values)

    rmod.render_wavefront(scene, width=W, height=H, samples=SPP, cfg=cfg,
                          go_camera=go_camera, hook=hook)
    return chunks, segs


def launches(scene, cfg, chunks, segs, counters=False, **kw):
    """(unsplit launch functions and outputs, segment launch functions);
    ``kw``: more arguments of prepare_trace."""
    unsplit, outs, cnts = [], [], []
    for c in chunks:
        cnt = None
        if counters:
            cnt = torch.zeros((c["origin"].shape[0], mk.BVH_COUNTERS),
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


def cuda_ms(fns):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for f in fns:
        f()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("stream", "bvh"), default="stream")
    ap.add_argument("--pkg", action="append", default=[],
                    help="LABEL=DIR: a directory holding another copy of "
                         "raytrace_tpu_torch")
    ap.add_argument("--serial", action="store_true",
                    help="stream mode: also time this build's per-thread "
                         "leaf walk")
    ap.add_argument("--in-place", action="store_true",
                    help="bvh mode: also time K3+K4 reading its walk table "
                         "in place")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_stream_walk: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    pkgs = [tuple(p.split("=", 1)) for p in args.pkg]
    blds = builds(args.mode, pkgs, args.serial, args.in_place)
    labels = list(blds)
    report = {"card": card(), "mode": args.mode, "builds": {}, "frames": {}}
    for label, b in blds.items():
        report["builds"][label] = {
            "library": os.path.basename(b.path), "smem_budget": b.budget,
            "kw": b.kw, "resources": {e: b.regs.get(e)
                                      for e in ENTRIES[args.mode]
                                      if e in b.regs}}
    cfgs = {"soft": trace_mod.TraceConfig(max_depth=DEPTH,
                                          shadow_samples=SOFT, seed=0)}
    cfgs["hard"] = dataclasses.replace(cfgs["soft"], soft_shadows=False)
    cfgs["none"] = cfgs["soft"]
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for frame, (src, go) in frames(args.mode, tmp).items():
            scene = load(src, dev)
            if mk._kernel_mode(scene) != args.mode:
                raise AssertionError(f"{frame} is not a {args.mode}-mode "
                                     "scene")
            chunks, segs = capture(scene, cfgs["soft"], go)
            if args.mode == "bvh":
                segs = []   # unsplit: one segment a chunk, its launch
            dark = without_lights(scene)
            rec = {"chunks": len(chunks), "segments": len(segs),
                   "lanes": sum(c["origin"].shape[0] for c in chunks),
                   "segment_lanes": sum(v["origin"].shape[0] for v in segs),
                   "ms": {}}
            if args.mode == "bvh":
                walk = mk.pack_walk_table(scene)
                rec["walk_bytes"] = 4 * walk.numel()
                rec["walk_in_smem"] = mk.walk_table_in_smem(walk)
                del walk
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
                    same = (torch.equal(rad, ref[0]),
                            torch.equal(cnt, ref[1]))
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
