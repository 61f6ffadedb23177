"""K5 (the stream-mode trace kernel) per launch on the card, with its
shadow walks split apart, for one or more builds in one process.

    python -m raytrace_tpu_torch.tools.measure_stream_walk \
        [--pkg LABEL=DIR ...] [--serial] [--reps N] [--out FILE]

For each stream bench frame of ``chip_smoke.py`` (grid-5833 and ico-10241
at 800x600, 100 spp, depth 50, 16 soft-shadow rays, seed 0) it captures
the main path's lanes (the trace chunks and the split ladder's segments,
through ``render_wavefront``'s hook) once, then times with CUDA events
K5's unsplit launch over every chunk and the ladder's segment launches,
under three settings: soft shadows on, soft shadows off, and the scene
without lights (no shadow walk at all). A lane's path does not depend on
its direct light, so the same segment inputs serve all three, and the
differences split K5's time into the closest-hit walk, the hard-shadow
walk and the fused soft walk.

Builds: this package's library ("this"; with ``--serial`` also its
per-thread leaf walk, ``rt_trace_stream_serial``), and each ``--pkg``
directory holding another copy of ``raytrace_tpu_torch`` (a parent
commit's, say), built by that copy's own ``_build`` in parallel. They are
timed in turns (ABBA) and must give equal radiance and equal per-lane
work counters. Prints a JSON summary (also written to ``--out``) with the
card's name and power limit and each build's registers. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
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
ENTRIES = ("rt_trace_stream_kernel", "rt_trace_stream_state_kernel",
           "rt_trace_stream_serial_kernel",
           "rt_trace_stream_serial_state_kernel")


def _build_in(pkg_dir: str) -> subprocess.Popen:
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from raytrace_tpu_torch.ops import _build; r = _build.build(); "
            "print(json.dumps([r.path, r.ptxas]))")
    return subprocess.Popen([sys.executable, "-c", code, pkg_dir],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


class _Entry:
    """A stand-in for ``_build.library()`` whose rt_trace_stream is the
    given function (a build's K5 launcher, same C signature)."""

    def __init__(self, fn):
        self.rt_trace_stream = fn


def builds(pkgs, serial):
    """{label: (launcher function, library path, registers)}."""
    procs = {label: _build_in(d) for label, d in pkgs}
    res = _build.build()
    own = _build.library()
    regs = _build.kernel_resources(res.ptxas)
    out = {"this": (own.rt_trace_stream, res.path, regs)}
    if serial:
        out["this-serial"] = (own.rt_trace_stream_serial, res.path, regs)
    for label, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"build of {label} failed:\n{stderr}")
        path, ptxas = json.loads(stdout.strip().splitlines()[-1])
        fn = getattr(ctypes.CDLL(path), "rt_trace_stream")
        fn.argtypes = own.rt_trace_stream.argtypes
        fn.restype = own.rt_trace_stream.restype
        out[label] = (fn, path, _build.kernel_resources(ptxas))
    return out


def without_lights(scene):
    dev = scene.device
    return dataclasses.replace(scene, lights=scene_mod.Lights(
        position=torch.zeros((0, 3), device=dev),
        color=torch.zeros((0, 3), device=dev),
        intensity=torch.zeros((0,), device=dev)))


def capture(scene, cfg):
    """The main path's trace chunks and ladder segments of one frame."""
    chunks, segs = [], []

    def hook(stage, **values):
        if stage == "lane_rays":
            chunks.append({k: values[k] for k in
                           ("origin", "direction", "pix", "samp")})
        elif stage == "segment":
            segs.append(values)

    rmod.render_wavefront(scene, width=W, height=H, samples=SPP, cfg=cfg,
                          hook=hook)
    return chunks, segs


def launches(scene, cfg, chunks, segs, counters=False):
    """(unsplit launch functions and outputs, segment launch functions)."""
    unsplit, outs, cnts = [], [], []
    for c in chunks:
        cnt = None
        if counters:
            cnt = torch.zeros((c["origin"].shape[0], mk.BVH_COUNTERS),
                              dtype=torch.int32, device=c["origin"].device)
            cnts.append(cnt)
        out, f = mk.prepare_trace(scene, c["origin"], c["direction"],
                                  c["pix"], c["samp"], cfg, counters=cnt)
        unsplit.append(f)
        outs.append(out)
    seg_fns = []
    for v in segs:
        last = v["b1"] >= cfg.max_depth
        kw = dict(start_bounce=v["b0"], return_state=not last,
                  end_bounce=None if last else v["b1"])
        if v["b0"] > 0:
            kw.update(init_throughput=v["throughput"], init_alive=v["alive"])
        seg_fns.append(mk.prepare_trace(scene, v["origin"], v["direction"],
                                        v["pix"], v["samp"], cfg, **kw)[1])
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
    ap.add_argument("--pkg", action="append", default=[],
                    help="LABEL=DIR: a directory holding another copy of "
                         "raytrace_tpu_torch")
    ap.add_argument("--serial", action="store_true",
                    help="also time this build's per-thread leaf walk")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_stream_walk: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    pkgs = [tuple(p.split("=", 1)) for p in args.pkg]
    blds = builds(pkgs, args.serial)
    labels = list(blds)
    report = {"card": card(), "builds": {}, "frames": {}}
    for label, (_, path, regs) in blds.items():
        report["builds"][label] = {
            "library": os.path.basename(path),
            "resources": {e: regs.get(e) for e in ENTRIES if e in regs}}
    cfgs = {"soft": trace_mod.TraceConfig(max_depth=DEPTH,
                                          shadow_samples=SOFT, seed=0)}
    cfgs["hard"] = dataclasses.replace(cfgs["soft"], soft_shadows=False)
    cfgs["none"] = cfgs["soft"]
    real_library = _build.library
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        scenes = {"grid-5833": suite.grid_scene_dict(),
                  "ico-10241": suite.mesh_scene_dict(tmp)}
        for frame, d in scenes.items():
            scene = scene_mod.from_dict(d, device=dev)[0]
            if mk._kernel_mode(scene) != "stream":
                raise AssertionError(f"{frame} is not a stream-mode scene")
            chunks, segs = capture(scene, cfgs["soft"])
            dark = without_lights(scene)
            rec = {"chunks": len(chunks), "segments": len(segs),
                   "lanes": sum(c["origin"].shape[0] for c in chunks),
                   "segment_lanes": sum(v["origin"].shape[0] for v in segs),
                   "ms": {}}
            ref = None
            for label in labels:
                _build.library = lambda fn=blds[label][0]: _Entry(fn)
                try:
                    run, outs, cnts, _ = launches(scene, cfgs["soft"],
                                                  chunks, [], counters=True)
                    for f in run:
                        f()
                    rad = torch.cat(outs)
                    cnt = torch.cat(cnts)
                finally:
                    _build.library = real_library
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
                    _build.library = lambda fn=blds[label][0]: _Entry(fn)
                    try:
                        for name, cfg in cfgs.items():
                            s = dark if name == "none" else scene
                            unsplit, _, _, seg_fns = launches(s, cfg, chunks,
                                                              segs)
                            for f in unsplit[:1]:
                                f()  # warm-up
                            t_u = cuda_ms(unsplit)
                            t_l = cuda_ms(seg_fns)
                            del unsplit, seg_fns
                            m = rec["ms"].setdefault(label, {}).setdefault(
                                name, {"unsplit": [], "ladder": []})
                            m["unsplit"].append(t_u)
                            m["ladder"].append(t_l)
                    finally:
                        _build.library = real_library
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
