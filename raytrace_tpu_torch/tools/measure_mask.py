"""The mask stage on the card for one or more builds in one process: K2,
K6 and K6-stream (the pre-pass and the kernel, timed apart).

    python -m raytrace_tpu_torch.tools.measure_mask \
        [--pkg LABEL=DIR ...] [--in-place] [--reps N] [--stage-reps N] \
        [--out FILE]

Cells, at 800x600 as ``chip_smoke.py`` renders them: K6 on ring-1000,
smooth_shading_demo (its look-at camera) and ico-2561 (two smooth
icospheres of 1,280 triangles over a plane); K6-stream on grid-5833 and
ico-10241; both with the Renderer's depth of field (L=0.1, F=10) on
ring-1000 and grid-5833; K2 on the bench scene, with depth of field,
textured_mirror_demo (its look-at camera), the icosphere golden without
its BVH (the loop frame), ring-2500 without a BVH (loop mode) and
ring-8000 without its ground and without a BVH (loop mode, 8,000
bounding spheres: K2's rows past the shared-memory budget). For each
cell and build it times, in turns (ABBA over ``--reps``):

- the mask launch as the main path runs it, the walk kernel alone and
  the pre-pass kernel alone (K6, K6-stream, whose walk builds its table
  in shared memory and runs the pre-pass only past the budget; a build
  without one reports 0), on the device: CUDA events
  around DEVICE_RUNS launches that the host enqueues while a sleep kernel
  holds the stream (``device_ms``), since one launch takes the host
  longer (ctypes and the wrapper, some 10-20 us) than these kernels run,
  and launches timed back to back from the host measure the host;
- the mask stage: ``prepare_pixel_mask`` plus the launch, on the host
  clock, synchronised, the median of ``--stage-reps`` (at least 20);
  and, for each build, the stage split into its prep
  (``prepare_pixel_mask``; of it, the time in the build's own host
  ``_mask_camera``, where its prep calls one), the launch and the
  renderer's cumsum over the mask (``stage_ms``).

Builds: this package ("this"); with ``--in-place`` also this build with
every mask table read in place ("this-inplace": ``MASK_SMEM_BYTES`` 0;
K2 then builds its rows one at a time); and each ``--pkg`` directory
holding
another copy of ``raytrace_tpu_torch`` (a parent commit's, or a variant of
this one), imported under a name of its own so that its own host code
prepares its own launches; the copies build in parallel with their own
``_build``. Every build's masks must equal this build's (exit code 1
otherwise). Prints a JSON summary (also written to ``--out``) with the
card's name and power limit, each build's registers of the mask entries
and each cell's table bytes. Needs a CUDA GPU.

A parent commit's package: ``git archive HEAD~1 raytrace_tpu_torch | tar
-x -C _ab/parent`` in a checkout (into a git-ignored directory), then
``--pkg parent=_ab/parent``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

import torch

from .. import scene as scene_mod
from .. import trace as trace_mod
from ..bench import suite
from ..ops import _build
from ..ops import megakernel as mk
from .measure_dma_stream import card
from .measure_stream_walk import _build_in, bench_dict, cuda_ms

W, H = 800, 600
DEVICE_RUNS = 200
HOLD_CYCLES = 100_000_000  # the sleep kernel: some 50 ms at 1.98 GHz
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MASK_ENTRIES = ("rt_mask_table_kernel", "rt_pixel_mask_bvh_kernel",
                "rt_pixel_mask_stream_kernel", "rt_pixel_mask_kernel",
                "rt_pixel_mask_dof_kernel", "rt_mask_camera_kernel")


def cells(tmp):
    """{name: (scene dict or asset path, go camera, depth of field, build
    a BVH)}."""
    asset = lambda n: os.path.join(REPO, "assets", f"{n}.json")
    return {"ring-1000": (suite.ring_scene_dict(1000), True, False, True),
            "smooth": (asset("smooth_shading_demo"), False, False, True),
            "ico-2561": (suite.mesh_scene_dict(tmp, subdiv=3), True, False,
                         True),
            "grid-5833": (suite.grid_scene_dict(), True, False, True),
            "ico-10241": (suite.mesh_scene_dict(tmp), True, False, True),
            "ring-1000-dof": (suite.ring_scene_dict(1000), True, True,
                              True),
            "grid-5833-dof": (suite.grid_scene_dict(), True, True, True),
            "bench": (bench_dict(), True, False, True),
            "bench-dof": (bench_dict(), True, True, True),
            "textured": (asset("textured_mirror_demo"), False, False, True),
            "loop": (suite.golden_scene_dict("mesh_smooth_icosphere")[0],
                     True, False, False),
            "ring-2500": (suite.ring_scene_dict(2500), True, False, False),
            "ring-8000-noground": (suite.bvh_scene_dict("ring8000-noground"),
                                   True, False, False)}


def load_scene(src, dev, accel=True):
    kw = {} if accel else dict(build_accel=False)
    if isinstance(src, str):
        return scene_mod.load(src, device=dev, **kw)[0]
    return scene_mod.from_dict(src, device=dev, **kw)[0]


def _alias(label: str, pkg_dir: str):
    """The megakernel module of the copy of raytrace_tpu_torch in
    pkg_dir, imported as a package of its own name (its modules import
    each other relatively)."""
    name = "rt_pkg_" + "".join(c if c.isalnum() else "_" for c in label)
    root = os.path.join(os.path.abspath(pkg_dir), "raytrace_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(name + ".ops.megakernel")


@dataclasses.dataclass
class Build:
    mk: object     # the build's megakernel module
    path: str
    regs: dict
    budget: object = None  # MASK_SMEM_BYTES while it prepares, or its own


@contextlib.contextmanager
def using(build):
    """Within the block, the build prepares its launches under its
    shared-memory budget."""
    if build.budget is None:
        yield
        return
    old = build.mk.MASK_SMEM_BYTES
    build.mk.MASK_SMEM_BYTES = build.budget
    try:
        yield
    finally:
        build.mk.MASK_SMEM_BYTES = old


def builds(pkgs, in_place=False):
    """{label: Build}: this package (and it reading every table in
    place) and each (label, dir) of ``pkgs``, built in parallel."""
    procs = {label: _build_in(d) for label, d in pkgs}
    res = _build.build()
    regs = _build.kernel_resources(res.ptxas)
    out = {"this": Build(mk, res.path, regs)}
    if in_place:
        out["this-inplace"] = Build(mk, res.path, regs, 0)
    for label, d in pkgs:
        stdout, stderr = procs[label].communicate(timeout=900)
        if procs[label].returncode != 0:
            raise RuntimeError(f"build of {label} failed:\n{stderr}")
        path, ptxas = json.loads(stdout.strip().splitlines()[-1])
        out[label] = Build(_alias(label, d), path,
                           _build.kernel_resources(ptxas))
    return out


def device_ms(fns, runs=DEVICE_RUNS):
    """ms of one run of the launches ``fns`` on the device: the stream is
    held by a sleep kernel while the host enqueues ``runs`` runs, and CUDA
    events time them back to back. Raises if the host took longer to
    enqueue them than the hold lasted (the time would be the host's)."""
    held, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    torch.cuda.synchronize()
    held.record()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(runs):
        for f in fns:
            f()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    hold_ms = held.elapsed_time(start)
    if host_ms >= hold_ms:
        raise RuntimeError(f"the host took {host_ms:.1f} ms to enqueue, "
                           f"longer than the {hold_ms:.1f} ms hold")
    return start.elapsed_time(end) / runs


def parts(launch):
    """(pre-pass or None, walk) of a prepared launch: a MaskLaunch, or a
    build's plain launch function (one kernel, no pre-pass)."""
    if hasattr(launch, "walk"):
        return launch.prepass, launch.walk
    return None, launch


def _sync_clock():
    torch.cuda.synchronize()
    return time.perf_counter()


def stage_ms(mkm, scene, cfg, go, reps):
    """The mask stage of a build on the host clock, synchronised, medians
    over ``reps`` in ms: {"stage": prepare_pixel_mask plus the launch, as
    the main path runs them; "prep": prepare_pixel_mask alone; "camera":
    the part of the prep spent in the build's own ``_mask_camera``, where
    its prep calls it (0 where the kernels build the camera row
    themselves, in the launch); "launch"; "cumsum": the renderer's
    inclusive cumsum over the mask}. The split times only what each
    build's prep does, so two builds compare on the whole stage."""
    kw = dict(width=W, height=H, cfg=cfg, go_camera=go)
    whole, prep, cam, launch_t, cum = [], [], [], [], []
    for _ in range(reps):
        t0 = _sync_clock()
        _, launch = mkm.prepare_pixel_mask(scene, **kw)
        launch()
        whole.append(_sync_clock() - t0)
    inner = []
    own = mkm._mask_camera

    def timed(*a, **k):
        t0 = _sync_clock()
        row = own(*a, **k)
        inner.append(_sync_clock() - t0)
        return row

    mkm._mask_camera = timed
    try:
        for _ in range(reps):
            inner.clear()
            t1 = _sync_clock()
            out, launch = mkm.prepare_pixel_mask(scene, **kw)
            t2 = _sync_clock()
            launch()
            t3 = _sync_clock()
            torch.cumsum(out.to(torch.int64), 0) - 1
            t4 = _sync_clock()
            prep.append(t2 - t1)
            cam.append(sum(inner))
            launch_t.append(t3 - t2)
            cum.append(t4 - t3)
    finally:
        mkm._mask_camera = own
    med = lambda xs: statistics.median(xs) * 1e3
    return {"stage": med(whole), "prep": med(prep), "camera": med(cam),
            "launch": med(launch_t), "cumsum": med(cum)}


def table_info(scene, cfg, go):
    """This build's mask table: (floats, in shared memory) or None (K2)."""
    _, launch = mk.prepare_pixel_mask(scene, width=W, height=H, cfg=cfg,
                                      go_camera=go)
    if launch.table is None:
        return None
    return int(launch.table.numel()), bool(launch.in_smem)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg", action="append", default=[],
                    help="LABEL=DIR: a directory holding another copy of "
                         "raytrace_tpu_torch")
    ap.add_argument("--in-place", action="store_true",
                    help="also time this build reading every table in "
                         "place")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--stage-reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_mask: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    blds = builds([tuple(p.split("=", 1)) for p in args.pkg],
                  args.in_place)
    labels = list(blds)
    report = {"card": card(), "builds": {
        label: {"library": os.path.basename(b.path),
                "resources": {e: b.regs.get(e) for e in MASK_ENTRIES
                              if e in b.regs}}
        for label, b in blds.items()}, "cells": {}}
    print(report["card"], flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for cell, (src, go, dof, accel) in cells(tmp).items():
            scene = load_scene(src, dev, accel)
            cfg = trace_mod.TraceConfig(depth_of_field=dof)
            info = table_info(scene, cfg, go)
            rec = {"mode": mk.require_mode(scene),
                   "kernel": mk.MASKS[mk.require_mode(scene)],
                   "n_nodes": scene.accel.n_nodes if scene.accel else 0,
                   "table_bytes": 4 * info[0] if info else None,
                   "table_in_smem": info[1] if info else None,
                   "equal_to_this": {}, "mask_ms": {}, "walk_ms": {},
                   "table_ms": {},
                   "host_walk_ms": {}, "stage_ms": {}}
            ref = None
            for label in labels:
                with using(blds[label]):
                    out, launch = blds[label].mk.prepare_pixel_mask(
                        scene, width=W, height=H, cfg=cfg, go_camera=go)
                launch()
                if ref is None:
                    ref = out
                    rec["hit_pixels"] = int(out.sum())
                same = bool(torch.equal(out, ref))
                rec["equal_to_this"][label] = same
                ok = ok and same
            for rep in range(args.reps):
                for label in (labels if rep % 2 == 0 else labels[::-1]):
                    b = blds[label]
                    with using(b):
                        _, launch = b.mk.prepare_pixel_mask(
                            scene, width=W, height=H, cfg=cfg, go_camera=go)
                    launch()
                    pre, walk = parts(launch)
                    rec["mask_ms"].setdefault(label, []).append(
                        device_ms([launch]))
                    rec["walk_ms"].setdefault(label, []).append(
                        device_ms([walk]))
                    rec["table_ms"].setdefault(label, []).append(
                        device_ms([pre]) if pre else 0.0)
                    rec["host_walk_ms"].setdefault(label, []).append(
                        cuda_ms([walk]))
                    with using(b):
                        rec["stage_ms"].setdefault(label, []).append(
                            stage_ms(b.mk, scene, cfg, go, args.stage_reps))
                    st = rec["stage_ms"][label][-1]
                    print(f"{cell} rep {rep} {label}: mask "
                          f"{rec['mask_ms'][label][-1]:.4f} ms, walk "
                          f"{rec['walk_ms'][label][-1]:.4f} ms (launched "
                          f"back to back from the host "
                          f"{rec['host_walk_ms'][label][-1]:.4f}), pre-pass "
                          f"{rec['table_ms'][label][-1]:.4f} ms, stage "
                          f"{st['stage']:.3f} ms (prep {st['prep']:.3f}, of "
                          f"it camera row {st['camera']:.3f}, launch "
                          f"{st['launch']:.3f}, cumsum {st['cumsum']:.3f})",
                          flush=True)
            report["cells"][cell] = rec
            del scene, ref
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
