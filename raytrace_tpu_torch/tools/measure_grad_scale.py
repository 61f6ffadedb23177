"""Gradient cost at 1K and 10K primitives (the port of
``tools/measure_grad_scale.py``).

    python -m raytrace_tpu_torch.tools.measure_grad_scale [--reps 3]
        [--device cpu]

At 64x48, 2 spp, depth 3, 2 shadow samples, on grid-1001 (brute force and
``keep_accel``) and ico-10241 (``keep_accel`` and brute force), the rows
of the JAX package's "Gradients at scale": the forward pass
(``diff.render_image`` without autograd) and the forward and backward
passes (``diff.render_and_grad``) in ms, 1 warm-up and the median of
``reps`` (1 timed run where a call takes over 5 s); the peak of
``torch.cuda.max_memory_allocated`` over the gradient call, less what
was allocated when it started (the call's own peak); the bounces
the forward pass ran and those the backward pass ran again (the
per-bounce checkpoints); every gradient finite; the light-intensity
gradient against a central difference (eps 0.1: radiance is linear in
intensity, so a large step is exact). On grid-1001 the ``keep_accel``
image must equal brute force's bit for bit and its material and light
gradients lie within rtol 1e-3, atol 1e-6 of them. Prints a line a row
and raises on a failed check. Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from .. import _device, diff
from .. import scene as scene_mod
from .. import trace as trace_mod
from ..bench import suite

W, H, SPP = 64, 48, 2
CFG = trace_mod.TraceConfig(max_depth=3, shadow_samples=2)
SLOW_S = 5.0        # past this a call is timed once
FD_EPS = 0.1
FD_RTOL = 2e-2
ACCEL_RTOL, ACCEL_ATOL = 1e-3, 1e-6


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(fn, device, reps):
    """(median ms of ``reps`` timed calls, or of one when a call takes
    over SLOW_S; the last call's result). The caller warms up."""
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
        if times[0] > SLOW_S:
            break
    return 1e3 * statistics.median(times), out


def measure_row(name, scene, keep_accel, *, width=W, height=H,
                samples=SPP, cfg=CFG, reps=3) -> dict:
    """One row: times, peak memory, bounces, checks; the image and the
    gradients ride along under "img" and "grads"."""
    device = scene.device
    params, merge = diff.split_params(scene, keep_accel=keep_accel)

    def forward():
        with torch.no_grad():
            return diff.render_image(merge(params), width, height, samples,
                                     cfg)

    def grad():
        return diff.render_and_grad(scene, width, height, samples=samples,
                                    cfg=cfg, keep_accel=keep_accel)

    # the warm-ups count the bounces (trace.BOUNCES): the forward pass's,
    # then those of the gradient call, which runs each again in its
    # backward pass
    run0 = trace_mod.BOUNCES["run"]
    forward()
    n_fwd = trace_mod.BOUNCES["run"] - run0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    grad()
    n_rerun = trace_mod.BOUNCES["run"] - run0 - 2 * n_fwd
    # the gradient call's own peak: above what was allocated before it
    peak = (torch.cuda.max_memory_allocated(device) - held
            if device.type == "cuda" else None)
    fwd_ms, _ = _ms(forward, device, reps)
    grad_ms, (img, grads) = _ms(grad, device, reps)
    finite = all(bool(torch.isfinite(v).all())
                 for sub in grads.values() for v in sub.values())
    g_int = float(grads["lights"]["intensity"][0])
    fd = diff.finite_difference_grad(
        scene, width, height, samples=samples, cfg=cfg, group="lights",
        field="intensity", index=(0,), eps=FD_EPS, keep_accel=keep_accel)
    row = {"scene": name, "prims": scene.prim_count,
           "path": "keep_accel" if keep_accel else "brute",
           "fwd_ms": fwd_ms, "grad_ms": grad_ms, "peak_bytes": peak,
           "bounces": n_fwd, "bounces_rerun": n_rerun, "finite": finite,
           "g_intensity": g_int, "fd_intensity": fd,
           "fd_ok": bool(np.isclose(g_int, fd, rtol=FD_RTOL, atol=1e-4)),
           "device": str(device), "img": img, "grads": grads}
    if not finite:
        raise AssertionError(f"{name} {row['path']}: a gradient is not "
                             "finite")
    if not row["fd_ok"]:
        raise AssertionError(f"{name} {row['path']}: intensity gradient "
                             f"{g_int} against the central difference {fd}")
    return row


def accel_agrees(accel_row, brute_row):
    """keep_accel against brute force: the image bit for bit, the
    material and light gradients within ACCEL_RTOL, ACCEL_ATOL. Returns
    the largest relative gradient error; raises when a check fails."""
    if not torch.equal(accel_row["img"], brute_row["img"]):
        raise AssertionError(f"{accel_row['scene']}: the keep_accel image "
                             "differs from brute force")
    worst = 0.0
    for grp in ("materials", "lights"):
        for f, va in accel_row["grads"][grp].items():
            vb = brute_row["grads"][grp][f]
            torch.testing.assert_close(va, vb, rtol=ACCEL_RTOL,
                                       atol=ACCEL_ATOL,
                                       msg=f"{grp}.{f} keep_accel vs brute")
            if va.numel():
                rel = ((va - vb).abs() / vb.abs().clamp(min=1e-30)).max()
                worst = max(worst, float(rel))
    return worst


def scenes(device, tmpdir):
    """The two scenes of the rows, on ``device``."""
    grid = scene_mod.from_dict(suite.grad_grid_scene_dict(),
                               device=device)[0]
    ico = scene_mod.from_dict(suite.mesh_scene_dict(tmpdir),
                              device=device)[0]
    return {"grid-1001": grid, "ico-10241": ico}


ROWS = (("grid-1001", False), ("grid-1001", True), ("ico-10241", True),
        ("ico-10241", False))


def line(row) -> str:
    peak = ("not measured" if row["peak_bytes"] is None
            else f"{row['peak_bytes'] / 2**30:.3f} GiB")
    return (f"{row['scene']} ({row['prims']} prims) {row['path']}: "
            f"forward {row['fwd_ms']:.1f} ms, forward+backward "
            f"{row['grad_ms']:.1f} ms, own peak {peak}, bounces "
            f"{row['bounces']} (+{row['bounces_rerun']} rerun), finite "
            f"{row['finite']}, d/d intensity {row['g_intensity']:.6g} vs "
            f"FD {row['fd_intensity']:.6g}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = _device.resolve(args.device)
    if device.type == "cuda":
        print(torch.cuda.get_device_name(device), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        sc = scenes(device, tmp)
        rows = {}
        for name, keep in ROWS:
            rows[name, keep] = measure_row(name, sc[name], keep,
                                           reps=args.reps)
            print(line(rows[name, keep]), flush=True)
    worst = accel_agrees(rows["grid-1001", True], rows["grid-1001", False])
    print(f"grid-1001: keep_accel image equals brute force; gradients "
          f"within {worst:.3g} relative", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
