"""A band worker of the cross-process recovery run (the port of
``tools/elastic_worker.py``).

    python -m raytrace_tpu_torch.tools.elastic_worker <role> <y0> <band_h> \\
        <workdir> [--device cpu]

Two independent processes each own a row band of one 32x24, 2 spp frame
and heartbeat through files in <workdir> after every chunk of rows (a
work-queue model: the failure-tolerant counterpart of the reference's
distributed renderer, whose failedJobs counter only counted,
distributed_renderer.go:93-104). Roles:

  victim    renders its band in chunks of rows by ``render_band``,
            heartbeating after each, and dies (``os._exit(3)``) after two
            chunks: a real crash with a real partial result on disk;
  survivor  renders its own band, then watches the victim's heartbeat;
            when it goes stale short of the band, it renders the missing
            rows again with ``parallel.rerender_missing_rows``, splices
            them with the victim's finished rows and its own band, and
            writes the recovered frame to <workdir>/recovered.npz.

Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .. import renderer as renderer_mod
from .. import scene as scene_mod
from .. import trace as trace_mod
from ..parallel import distributed as dist_mod
from .dist_worker import SCENE_DICT

W, H, SPP = 32, 24, 2
CHUNK = 3          # rows a heartbeat
DIE_AFTER = 2      # the victim dies after this many chunks
STALE_S = 4.0      # a heartbeat older than this is a dead worker
CFG = trace_mod.TraceConfig(max_depth=3, shadow_samples=2)


def _hb_path(d, role):
    return os.path.join(d, f"hb_{role}.json")


def _part_path(d, role):
    return os.path.join(d, f"part_{role}.npz")


def _beat(d, role, rows_done, y0, band_h):
    tmp = _hb_path(d, role) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"rows_done": rows_done, "y0": y0, "band_h": band_h,
                   "t": time.time()}, f)
    os.replace(tmp, _hb_path(d, role))


def _wait_for_death(workdir: str, timeout: float = 120.0) -> dict:
    """The victim's last heartbeat, once it is stale short of its band."""
    deadline = time.time() + timeout
    while True:
        if time.time() > deadline:
            raise RuntimeError("the victim neither finished nor went stale")
        try:
            with open(_hb_path(workdir, "victim")) as f:
                hb = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            time.sleep(0.2)
            continue
        if hb["rows_done"] >= hb["band_h"]:
            raise RuntimeError("the victim finished: nothing to recover")
        if time.time() - hb["t"] > STALE_S:
            return hb
        time.sleep(0.2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("role", choices=("victim", "survivor"))
    ap.add_argument("y0", type=int)
    ap.add_argument("band_h", type=int)
    ap.add_argument("workdir")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    r = renderer_mod.Renderer(device=a.device)
    r.samples, r.max_depth = SPP, CFG.max_depth
    scene = scene_mod.from_dict(SCENE_DICT, device=r.device)[0]

    band = np.zeros((a.band_h, W, 3), np.float32)
    done = chunks = 0
    _beat(a.workdir, a.role, 0, a.y0, a.band_h)
    while done < a.band_h:
        h = min(CHUNK, a.band_h - done)
        rows = renderer_mod.render_band(scene, a.y0 + done, width=W,
                                        height=H, band_h=h, samples=SPP,
                                        cfg=CFG)
        band[done:done + h] = rows.cpu().numpy()
        done += h
        chunks += 1
        # the progress is on disk before the heartbeat that announces it
        tmp = _part_path(a.workdir, a.role)[:-4] + ".tmp.npz"
        np.savez(tmp, band=band, rows_done=done, y0=a.y0)
        os.replace(tmp, _part_path(a.workdir, a.role))
        _beat(a.workdir, a.role, done, a.y0, a.band_h)
        if a.role == "victim" and chunks >= DIE_AFTER:
            os._exit(3)  # the crash: no clean-up, no last write
    if a.role != "survivor":
        return 0

    hb = _wait_for_death(a.workdir)
    vy0, vdone, vband_h = hb["y0"], hb["rows_done"], hb["band_h"]
    missing = list(range(vy0 + vdone, vy0 + vband_h))
    with np.load(_part_path(a.workdir, "victim")) as vic:
        if int(vic["rows_done"]) != vdone:
            raise RuntimeError("the victim's rows on disk disagree with its "
                               "heartbeat")
        vband = vic["band"][:vdone]
    full = np.zeros((H, W, 3), np.float32)
    full[a.y0:a.y0 + a.band_h] = band     # own rows
    full[vy0:vy0 + vdone] = vband         # the victim's finished rows
    recovered = dist_mod.rerender_missing_rows(r, scene, full, missing, W, H,
                                               cfg=CFG)
    np.savez(os.path.join(a.workdir, "recovered.npz"), img=recovered,
             missing=np.asarray(missing, np.int32), victim_rows_done=vdone)
    return 0


if __name__ == "__main__":
    sys.exit(main())
