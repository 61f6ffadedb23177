"""Adaptive sampling: variance-guided per-pixel sample allocation.

Port of ``raytrace_tpu/adaptive.py``. Every sample's radiance is a pure
function of (pixel, sample, seed), never of the batch that computed it,
so sampling can stop per pixel at any point and the partial mean is the
fixed-spp estimator truncated to that count. Batches of samples are drawn
for the pixels still unconverged only (a pixel-major wavefront built from
explicit pixel ids, as the renderer's compaction builds one), so flat
regions stop at ``min_spp`` while penumbras and glass keep sampling up to
``max_spp``.

Convergence test, run when ``min_spp <= s0 < max_spp`` (s0 the samples
each active pixel has taken): the standard error of the per-pixel
luminance, ``sqrt(var / n) <= abs_tol + rel_tol * max(mean, 0)``. The
tolerances are in linear radiance.

Each batch traces through the port's trace kernels (``megakernel.trace``:
K1, K3+K4, K5 or K7 on the card, their plain version on the CPU), in
chunks of at most ``renderer.TRACE_LANES`` lanes. A glassy stream scene
(``pick_split`` set and ``pick_deep_caps`` "const") traces through the
survivor ladder (``renderer.trace_with_split``) at full capacity: every
level's capacity is its lane count, so no survivor can overflow. Two
accumulation modes:

- ``accum="host"``: the batch's sums come to the host and accumulate in
  float64; the convergence test runs on the host between batches.
- ``accum="device"``: the per-pixel sums (float32), the test and the
  compaction of the active set stay on the device; the host reads one
  scalar, the surviving-pixel count, per test round. Images equal the
  host mode's up to the order and precision of the sums, and a pixel
  near the threshold can decide differently; resume is bit-identical
  within the mode (float32 sums round-trip exactly through the float64
  checkpoint).

``accum=None`` is "device" on CUDA and "host" on the CPU, as the JAX
package picks "device" on a TPU.

Checkpoints (``checkpoint_path``) hold the whole sampler state in an
atomic npz with the JAX package's state keys. The header pins every input
that steers the sample sequence or the decisions, and (a departure from
the JAX package, whose checkpoints lack it) the effective split spec: a
resume under another split policy would mix split and unsplit batch sums.
A port checkpoint does not resume a JAX checkpoint, nor the reverse: the
scene fingerprints hash different tables.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from . import _device
from . import renderer as renderer_mod
from . import trace as trace_mod

__all__ = ["render_adaptive"]

# Rec.709 luma weights: the variance is tested on one scalar per pixel.
_LUMA = (0.2126, 0.7152, 0.0722)

_CKPT_VERSION = 1
# The sampler state an adaptive checkpoint holds (the JAX package's keys).
_STATE_KEYS = ("sum_rgb", "sum_y", "sum_y2", "n_taken", "active", "s0")


def _no_hook(stage, **values):
    pass


def _split_spec(scene, cfg: trace_mod.TraceConfig):
    """The split ladder of the batches: ``pick_split`` for a glassy stream
    scene (``pick_deep_caps`` "const"), else 0 (unsplit). Fast-decay
    scenes stay unsplit: at full capacity their deep levels would relaunch
    mostly dead lanes."""
    sp = renderer_mod.pick_split(scene, cfg)
    if sp and renderer_mod.pick_deep_caps(scene) == "const":
        return sp
    return 0


def _batch_sums(scene, active: torch.Tensor, s0: int, *, width: int,
                height: int, batch: int, cfg: trace_mod.TraceConfig,
                go_camera: bool, split=0, hook=_no_hook) -> torch.Tensor:
    """Radiance sums of the samples [s0, s0 + batch) of each pixel id in
    ``active`` (k,): (k, 5) float32 [rgb, luma, luma^2] on the scene's
    device. Lanes are pixel-major, in chunks of at most TRACE_LANES.
    ``hook`` sees each chunk's "lane_rays", the trace's "segment" and
    "split_compact" stages, "trace" (radiance and the ladder's overflow,
    a 0-d tensor that stays on the device) and "sums"."""
    dev = scene.device
    luma_w = torch.tensor(_LUMA, dtype=torch.float32, device=dev)
    per = max(1, renderer_mod.TRACE_LANES // batch)
    out = []
    for px in active.split(per):
        pix, samp = renderer_mod._lane_ids(px, batch, offset=s0)
        origin, direction = renderer_mod._lane_rays(
            scene, pix, samp, width=width, height=height, cfg=cfg,
            go_camera=go_camera)
        hook("lane_rays", px=px, pix=pix, samp=samp, origin=origin,
             direction=direction, s0=s0)
        rad, ov = renderer_mod.trace_with_split(
            scene, origin, direction, pix, samp, cfg, split=split,
            surv_cap=pix.shape[0] if split else 0, deep_caps="const",
            hook=hook)
        hook("trace", rad=rad, overflow=ov, s0=s0)
        rad = rad.reshape(-1, batch, 3)
        luma = rad @ luma_w
        out.append(torch.cat([rad.sum(dim=1), luma.sum(dim=1)[:, None],
                              (luma * luma).sum(dim=1)[:, None]], 1))
        hook("sums", sums=out[-1], s0=s0)
    if not out:
        return torch.zeros((0, 5), dtype=torch.float32, device=dev)
    return torch.cat(out)


def _batch_sums_sharded(scene, active: torch.Tensor, s0: int, *, mesh,
                        hook=_no_hook, **kw) -> torch.Tensor:
    """``_batch_sums`` with the active pixels split over every coordinate
    of ``mesh`` (raytrace_tpu/adaptive.py:_batch_sums_sharded): contiguous
    runs of the active set, in the coordinates' row-major order, each
    traced on its coordinate's device, the sums gathered in order on the
    device of ``active``. A pixel's whole batch stays on one coordinate
    and every draw is keyed by (pixel, sample), so the sums, and with them
    the spp decisions, are those of the unsharded run. (The JAX package
    pads the active set to a multiple of the coordinate count; the port
    traces the live rows alone, so runs differ by one pixel at most.)
    Across processes each process traces its own coordinates' runs and
    one ``all_reduce`` of the zero-filled (k, 5) sums assembles them on
    every process (the runs are disjoint: the sum is exact)."""
    home = active.device
    px, sp = mesh.devices.shape
    runs = torch.tensor_split(active, px * sp)
    out = torch.zeros((active.shape[0], 5), dtype=torch.float32,
                      device=home)
    scenes = {}
    start = 0
    for c, run in enumerate(runs):
        i, j = divmod(c, sp)
        if run.numel() and mesh.is_local(i, j):
            dev = mesh.devices[i, j]
            if dev not in scenes:
                scenes[dev] = scene.to(dev)
            part = _batch_sums(scenes[dev], run.to(dev), s0, hook=hook, **kw)
            out[start:start + run.shape[0]] = part.to(home)
        start += run.shape[0]
    if mesh.multi_process:
        torch.distributed.all_reduce(out)
    return out


def _stderr_keep(sums: torch.Tensor, n: int, rel_tol: float,
                 abs_tol: float) -> torch.Tensor:
    """(k,) bool: the rows of ``sums`` (k,5) whose luminance standard
    error after n samples is still above the tolerance (float32, as the
    JAX package's device round computes it)."""
    nf = torch.full((), float(n), dtype=sums.dtype, device=sums.device)
    mean = sums[:, 3] / nf
    var = torch.clamp((sums[:, 4] / nf - mean * mean)
                      * (nf / torch.clamp(nf - 1.0, min=1.0)), min=0.0)
    stderr = torch.sqrt(var / nf)
    return stderr > abs_tol + rel_tol * torch.clamp(mean, min=0.0)


def _device_round(act_ids, act_sums, full_sums, spp_map, n: int, *,
                  rel_tol: float, abs_tol: float):
    """The convergence test of a device round: flush the converged rows of
    the active-aligned state (act_ids (k,), act_sums (k,5)) into the
    pixel-aligned full_sums (n_px+1,5) and spp_map (n_px+1,), in place, by
    a scatter-add of those rows only (the others go to the dump row
    n_px), and re-compact the survivors stably to the front with a cumsum
    permutation. Returns (act_ids, act_sums, survivors as a 0-d tensor on
    the device)."""
    n_px = full_sums.shape[0] - 1
    keep = _stderr_keep(act_sums, n, rel_tol, abs_tol)
    drop = ~keep
    idx = torch.where(drop, act_ids, torch.full_like(act_ids, n_px))
    full_sums.index_add_(0, idx, torch.where(drop[:, None], act_sums, 0.0))
    spp_map.scatter_(0, idx, torch.full_like(idx, n, dtype=spp_map.dtype))
    keep_i = keep.to(torch.int64)
    ck = torch.cumsum(keep_i, 0)
    n_keep = ck[-1]
    pos = torch.where(keep, ck - 1, n_keep + torch.cumsum(1 - keep_i, 0) - 1)
    ids = torch.empty_like(act_ids).index_copy_(0, pos, act_ids)
    sums = torch.empty_like(act_sums).index_copy_(0, pos, act_sums)
    return ids, sums, n_keep


def _device_finish(act_ids, act_sums, full_sums, spp_map, s0: int):
    """Flush the rows still active (they ran to s0, the cap) and turn the
    sums into (img (n_px,3), spp (n_px,) int32, variance of the mean of
    the luminance (n_px,))."""
    n_px = full_sums.shape[0] - 1
    full_sums.index_add_(0, act_ids, act_sums)
    spp_map.index_fill_(0, act_ids, s0)
    full, spp = full_sums[:n_px], spp_map[:n_px]
    n = torch.clamp(spp, min=1).to(torch.float32)
    img = full[:, :3] / n[:, None]
    mean = full[:, 3] / n
    var = torch.clamp((full[:, 4] / n - mean * mean)
                      * (n / torch.clamp(n - 1.0, min=1.0)), min=0.0)
    return img, spp, var / n


def _save_ckpt(path: str, header: dict, state: dict) -> None:
    """Atomic npz write (a temporary file, then a rename)."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, version=_CKPT_VERSION, **header, **state)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_ckpt(path: str, header: dict) -> dict:
    """The state of a checkpoint whose header equals ``header``; raises
    ValueError on another schema, a differing header entry or a missing
    one (a checkpoint without the split spec is refused)."""
    with np.load(path) as z:
        if int(z["version"]) != _CKPT_VERSION:
            raise ValueError(f"adaptive checkpoint schema "
                             f"{int(z['version'])} != {_CKPT_VERSION}")
        for k, v in header.items():
            if k not in z.files:
                raise ValueError(
                    f"adaptive checkpoint lacks {k!r}: it cannot show that "
                    f"resuming keeps the sample sequence and the decisions")
            got = z[k]
            same = (str(got) == str(v) if isinstance(v, str)
                    else np.allclose(np.asarray(got), np.asarray(v)))
            if not same:
                raise ValueError(
                    f"adaptive checkpoint mismatch on {k}: {got} != {v} - "
                    f"resuming would change the sample sequence or the "
                    f"convergence decisions")
        return {k: z[k] for k in _STATE_KEYS}


def _scene_fingerprint(scene) -> str:
    """sha256 over the scene's tables (geometry, materials, lights, camera,
    the BVH and stream tables), in the dataclasses' field order, each
    tensor moved to the CPU first, so the hash does not depend on the
    device: a resumed accumulation must be fed by the same scene."""
    h = hashlib.sha256()

    def feed(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            h.update(f.name.encode())
            if isinstance(v, torch.Tensor):
                a = v.detach().cpu().contiguous()
                h.update(f"{a.dtype}{tuple(a.shape)}".encode())
                h.update(a.numpy().tobytes())
            elif dataclasses.is_dataclass(v) and not isinstance(v, type):
                feed(v)
            else:
                h.update(repr(v).encode())

    feed(scene)
    return h.hexdigest()[:16]


def render_adaptive(scene, *, width: int, height: int,
                    cfg: Optional[trace_mod.TraceConfig] = None,
                    min_spp: int = 8, max_spp: int = 64, batch: int = 8,
                    rel_tol: float = 0.02, abs_tol: float = 1e-4,
                    go_camera: bool = True, pad_quantum: int = 1024,
                    return_variance: bool = False, mesh=None,
                    checkpoint_path: Optional[str] = None,
                    checkpoint_every: int = 1, resume: bool = True,
                    accum: Optional[str] = None, as_numpy: bool = True,
                    device=None, hook=_no_hook):
    """Render with per-pixel adaptive sample counts.

    Returns (linear image (H,W,3) float32, spp map (H,W) int32), and with
    ``return_variance`` the (H,W) variance of the mean of each pixel's
    luminance (``denoising.denoise``'s ``variance=``); numpy, or with
    ``as_numpy=False`` tensors on the device. Every pixel takes samples
    0..n-1 of the sample sequence, so with rel_tol = abs_tol = 0 the image
    equals a fixed max_spp render up to the order of the sums.

    The first active set is the conservative mask's (``renderer
    ._pixel_mask``: K2, K6 or K6-stream on the card): pixels outside it
    are exact black with spp 0. The mask is the cone mask on every device,
    a superset of the JAX package's CPU mask (every jittered ray tested):
    its extra pixels are black, have no variance and stop at the first
    test round. A resumed render carries its active set.

    Runs on ``device`` (default CUDA, or with a ``mesh`` its home device;
    raises without a GPU unless ``device="cpu"`` or a mesh of CPU devices
    is given), the scene moved there. ``mesh`` (``parallel.make_mesh``)
    splits each batch's active pixels over its coordinates
    (``_batch_sums_sharded``): in both accumulation modes the sums and
    the spp decisions are those of the unsharded run. ``pad_quantum`` is
    kept for the JAX signature and unused: the JAX package pads the active
    set to limit recompiles (and under a mesh rounds the padding to the
    coordinate count), the port traces the live rows only. ``hook(stage,
    **values)`` sees the
    stages "mask", "round" (s0, batch, test) before each batch, those of
    ``_batch_sums``, in device mode "k_read" (the one host read of a test
    round), and "finish" after the last batch.
    """
    if cfg is None:
        cfg = trace_mod.TraceConfig()
    if not 0 < min_spp <= max_spp:
        raise ValueError("need 0 < min_spp <= max_spp")
    dev = _device.resolve(mesh.home if mesh is not None and device is None
                          else device)
    scene = scene.to(dev)
    if accum is None:
        accum = "device" if dev.type == "cuda" else "host"
    if accum not in ("host", "device"):
        raise ValueError(f"accum must be 'host' or 'device', got {accum!r}")
    del pad_quantum
    split_spec = _split_spec(scene, cfg)

    n_px = width * height
    sum_rgb = np.zeros((n_px, 3), np.float64)
    sum_y = np.zeros(n_px, np.float64)
    sum_y2 = np.zeros(n_px, np.float64)
    n_taken = np.zeros(n_px, np.int64)
    active = None
    s0 = 0
    header = {"width": width, "height": height,
              "min_spp": min_spp, "max_spp": max_spp, "batch": batch,
              "rel_tol": rel_tol, "abs_tol": abs_tol,
              "cfg_repr": repr(cfg), "go_camera": go_camera,
              # a host float64 prefix continued in float32 (or the
              # reverse) is neither mode's uninterrupted run
              "accum": accum,
              # a resume under another split policy mixes split and
              # unsplit batch sums (the JAX package does not record it)
              "split": repr(split_spec)}
    if checkpoint_path:
        header["scene_sha"] = _scene_fingerprint(scene)
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        st = _load_ckpt(checkpoint_path, header)
        sum_rgb, sum_y, sum_y2 = st["sum_rgb"], st["sum_y"], st["sum_y2"]
        n_taken = st["n_taken"]
        active = st["active"].astype(np.int64)
        s0 = int(st["s0"])
    if active is None:
        hit_px, pos_px = renderer_mod._pixel_mask(
            scene, width=width, height=height, cfg=cfg, go_camera=go_camera)
        hook("mask", hit=hit_px, pos=pos_px)
        k0 = int(pos_px[-1]) + 1
        active = renderer_mod._compact_pixels(hit_px, pos_px, k0).cpu(
        ).numpy()

    kw = dict(scene=scene, sum_rgb=sum_rgb, sum_y=sum_y, sum_y2=sum_y2,
              n_taken=n_taken, active=active, s0=s0, width=width,
              height=height, cfg=cfg, min_spp=min_spp, max_spp=max_spp,
              batch=batch, rel_tol=rel_tol, abs_tol=abs_tol,
              go_camera=go_camera, return_variance=return_variance,
              checkpoint_path=checkpoint_path,
              checkpoint_every=checkpoint_every, header=header,
              as_numpy=as_numpy, split_spec=split_spec, hook=hook,
              sums=(_batch_sums if mesh is None else functools.partial(
                  _batch_sums_sharded, mesh=mesh)))
    if accum == "device":
        return _render_adaptive_device(**kw)
    return _render_adaptive_host(**kw)


def _render_adaptive_host(*, scene, sum_rgb, sum_y, sum_y2, n_taken, active,
                          s0, width, height, cfg, min_spp, max_spp, batch,
                          rel_tol, abs_tol, go_camera, return_variance,
                          checkpoint_path, checkpoint_every, header,
                          as_numpy, split_spec, hook, sums):
    """The accum="host" loop: each batch's sums come to the host and
    accumulate in float64; the test runs on the host."""
    dev = scene.device

    def flush():
        _save_ckpt(checkpoint_path, header,
                   {"sum_rgb": sum_rgb, "sum_y": sum_y, "sum_y2": sum_y2,
                    "n_taken": n_taken, "active": active, "s0": s0})

    batches_done = 0
    while active.size and s0 < max_spp:
        b = int(min(batch, max_spp - s0))
        hook("round", s0=s0, batch=b, test=min_spp <= s0 + b < max_spp)
        add = sums(scene, torch.from_numpy(active).to(dev), s0,
                   width=width, height=height, batch=b, cfg=cfg,
                   go_camera=go_camera, split=split_spec, hook=hook)
        add = add.to(torch.float64).cpu().numpy()
        sum_rgb[active] += add[:, :3]
        sum_y[active] += add[:, 3]
        sum_y2[active] += add[:, 4]
        n_taken[active] += b
        s0 += b
        if min_spp <= s0 < max_spp:
            n = float(s0)
            mean = sum_y[active] / n
            # unbiased per-sample variance; the clamp catches the
            # cancellation negatives of exactly converged pixels
            var = np.maximum(0.0, (sum_y2[active] / n - mean * mean)
                             * (n / max(n - 1.0, 1.0)))
            keep = np.sqrt(var / n) > (abs_tol
                                       + rel_tol * np.maximum(mean, 0.0))
            active = active[keep]
        batches_done += 1
        if checkpoint_path and batches_done % max(1, checkpoint_every) == 0:
            flush()

    hook("finish", s0=s0)
    if checkpoint_path:
        flush()  # the final state: a re-run resumes and returns at once
    img = (sum_rgb / np.maximum(n_taken, 1)[:, None]).astype(np.float32)
    out = (img.reshape(height, width, 3),
           n_taken.astype(np.int32).reshape(height, width))
    if return_variance:
        n = np.maximum(n_taken, 1).astype(np.float64)
        mean = sum_y / n
        var = np.maximum(0.0, (sum_y2 / n - mean * mean)
                         * (n / np.maximum(n - 1.0, 1.0)))
        out = out + ((var / n).astype(np.float32).reshape(height, width),)
    if not as_numpy:
        out = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in out)
    return out


def _render_adaptive_device(*, scene, sum_rgb, sum_y, sum_y2, n_taken,
                            active, s0, width, height, cfg, min_spp,
                            max_spp, batch, rel_tol, abs_tol, go_camera,
                            return_variance, checkpoint_path,
                            checkpoint_every, header, as_numpy, split_spec,
                            hook, sums):
    """The accum="device" loop: the state (act_ids (k,), act_sums (k,5)
    float32 active-aligned; full_sums (n_px+1,5) and spp_map (n_px+1,)
    pixel-aligned, row n_px the dump row) stays on the device; the host
    reads the survivor count once a test round. Checkpoints pull the state
    and write the host mode's npz schema."""
    dev = scene.device
    n_px = width * height
    k = int(active.size)
    act_ids = torch.from_numpy(active.astype(np.int64)).to(dev)
    if s0 == 0:  # a fresh start: every sum is zero, made on the device
        act_sums = torch.zeros((k, 5), dtype=torch.float32, device=dev)
        full_sums = torch.zeros((n_px + 1, 5), dtype=torch.float32,
                                device=dev)
        spp_map = torch.zeros(n_px + 1, dtype=torch.int32, device=dev)
    else:  # a resumed one: the checkpoint's float64 sums, back to float32
        act = np.concatenate([sum_rgb[active], sum_y[active, None],
                              sum_y2[active, None]], axis=1)
        full = np.zeros((n_px + 1, 5), np.float32)
        full[:n_px] = np.concatenate(
            [sum_rgb, sum_y[:, None], sum_y2[:, None]], axis=1)
        full[active] = 0.0  # active rows live in act_sums until they drop
        spp = np.zeros(n_px + 1, np.int32)
        spp[:n_px] = n_taken
        spp[active] = 0
        act_sums = torch.from_numpy(act.astype(np.float32)).to(dev)
        full_sums = torch.from_numpy(full).to(dev)
        spp_map = torch.from_numpy(spp).to(dev)

    def flush():
        a_ids = act_ids.cpu().numpy()
        a_sums = act_sums.cpu().numpy().astype(np.float64)
        f = full_sums[:n_px].cpu().numpy().astype(np.float64)
        rgb, y, y2 = f[:, :3].copy(), f[:, 3].copy(), f[:, 4].copy()
        rgb[a_ids] = a_sums[:, :3]
        y[a_ids] = a_sums[:, 3]
        y2[a_ids] = a_sums[:, 4]
        nt = spp_map[:n_px].cpu().numpy().astype(np.int64)
        nt[a_ids] = s0
        _save_ckpt(checkpoint_path, header,
                   {"sum_rgb": rgb, "sum_y": y, "sum_y2": y2,
                    "n_taken": nt, "active": a_ids, "s0": s0})

    batches_done = 0
    while k and s0 < max_spp:
        b = int(min(batch, max_spp - s0))
        do_test = min_spp <= s0 + b < max_spp
        hook("round", s0=s0, batch=b, test=do_test)
        act_sums = act_sums + sums(
            scene, act_ids, s0, width=width, height=height, batch=b,
            cfg=cfg, go_camera=go_camera, split=split_spec, hook=hook)
        s0 += b
        if do_test:
            act_ids, act_sums, n_keep = _device_round(
                act_ids, act_sums, full_sums, spp_map, s0, rel_tol=rel_tol,
                abs_tol=abs_tol)
            k = int(n_keep)  # the one host read of a test round
            hook("k_read", s0=s0, k=k)
            act_ids, act_sums = act_ids[:k], act_sums[:k]
        batches_done += 1
        if checkpoint_path and batches_done % max(1, checkpoint_every) == 0:
            flush()

    hook("finish", s0=s0)
    img, spp_d, var = _device_finish(act_ids, act_sums, full_sums, spp_map,
                                     s0)
    if checkpoint_path:
        flush()  # the final state: a re-run resumes and returns at once
    out = (img.reshape(height, width, 3), spp_d.reshape(height, width))
    if return_variance:
        out = out + (var.reshape(height, width),)
    if as_numpy:
        out = tuple(a.cpu().numpy() for a in out)
    return out
