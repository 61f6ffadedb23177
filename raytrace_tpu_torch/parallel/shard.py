"""Sharded rendering over a (px, sp) mesh (``parallel/mesh.py``).

Port of ``raytrace_tpu/parallel/shard.py``, the working form of both of
the reference's scale-out layers: the in-process tile pool
(renderer.go:76-99,398-436) becomes the px shards, each rendering its
block of pixels, and the HTTP distributed renderer
(distributed_renderer.go:76-106,153-196) becomes a ``torch.distributed``
``all_reduce`` across processes.

Within a process the shards run one after the other on their devices
(the launches are asynchronous, so the shards of different cards overlap
on their devices), their per-pixel partial sums are added over sp in a
fixed order on the px shard's device, and the results are gathered on the
mesh's home device. Across processes each process fills the rows of its
own shards into a zeroed buffer and one ``all_reduce`` (a sum) assembles
it on every process: the shards' rows are disjoint, so a row receives one
nonzero term and the sum is exact. (``all_reduce`` is the one collective
that both backends take on CUDA tensors: gloo runs no all-gather on
them.)

Determinism: every draw is keyed by (pixel, sample) and never by a
device, so every mesh shape gives the unsharded image (bit for bit where
each pixel's samples are summed in one order, as with sp = 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import renderer as renderer_mod
from .. import trace as trace_mod
from ..ops import megakernel


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _all_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the processes of the group (in place), where the
    mesh spans more than one."""
    if mesh.multi_process:
        torch.distributed.all_reduce(t)
    return t


class _Scenes:
    """The scene on each device of a call, moved once a device."""

    def __init__(self, scene):
        self.by_device = {scene.device: scene}
        self.scene = scene

    def on(self, device):
        if device not in self.by_device:
            self.by_device[device] = self.scene.to(device)
        return self.by_device[device]


def render_band_sharded(scene, band_y0: int, *, width: int, height: int,
                        band_h: int, samples: int,
                        cfg: trace_mod.TraceConfig, mesh,
                        go_camera: bool = True) -> torch.Tensor:
    """The mean linear radiance of rows [band_y0, band_y0 + band_h),
    (band_h, W, 3) on the mesh's home device (on every process), pixels
    sharded over ``px`` and samples over ``sp``.

    The pixels are padded to a multiple of px and the samples to a
    multiple of sp; padded sample lanes add zero (padded pixels lie past
    the band and are cut off). Each coordinate traces its lanes by the
    eager engine (``renderer.lane_radiance``: no kernel, as the JAX
    function runs jnp), sums each pixel's samples, and the px shard adds
    its sp partial sums in order on its device."""
    n_px = band_h * width
    n_shards, n_sp = mesh.shape["px"], mesh.shape["sp"]
    np_l = _round_up(n_px, n_shards) // n_shards
    ns_l = _round_up(samples, n_sp) // n_sp
    home = mesh.home
    out = torch.zeros((n_shards * np_l, 3), dtype=torch.float32, device=home)
    scenes = _Scenes(scene)
    for i in range(n_shards):
        total = None
        for j in range(n_sp):
            if not mesh.is_local(i, j):
                continue
            dev = mesh.devices[i, j]
            pixels = band_y0 * width + torch.arange(i * np_l, (i + 1) * np_l,
                                                    device=dev)
            pix, samp = renderer_mod._lane_ids(pixels, ns_l, offset=j * ns_l)
            rad = renderer_mod.lane_radiance(
                scenes.on(dev), pix, samp, width=width, height=height,
                cfg=cfg, go_camera=go_camera)
            rad = torch.where((samp < samples)[:, None], rad, 0.0)
            part = rad.reshape(np_l, ns_l, 3).sum(dim=1)
            total = part if total is None else total + part.to(total.device)
        if total is not None:
            out[i * np_l:(i + 1) * np_l] = total.to(home)
    out = _all_sum(out, mesh)
    return (out[:n_px] / samples).reshape(band_h, width, 3)


def _band_wavefront(scene, row0: int, rows: int, *, width: int, height: int,
                    samples: int, cfg: trace_mod.TraceConfig,
                    go_camera: bool, px_capacity: int, split, deep_caps):
    """One px shard of ``render_wavefront_sharded``: the single-card
    pipeline on rows [row0, row0 + rows). Returns (its (rows, W, 3) mean
    image, its overflow, a 0-d tensor on the device)."""
    hit = megakernel.pixel_mask(
        scene, width=width, height=height, cfg=cfg, go_camera=go_camera,
        row0=row0, rows=rows)
    pos = torch.cumsum(hit.to(torch.int64), 0) - 1
    k = pos[-1] + 1
    overflow = torch.clamp(k - px_capacity, min=0)
    base = row0 * width
    pixels = base + renderer_mod._compact_pixels(hit, pos, px_capacity)
    img, s_ov = renderer_mod._trace_compacted_pixels(
        scene, pixels, k, width=width, height=height, samples=samples,
        cfg=cfg, go_camera=go_camera, split=split, deep_caps=deep_caps,
        row0=row0, rows=rows)
    return img, overflow + s_ov


def render_wavefront_sharded(scene, *, width: int, height: int,
                             samples: int, cfg: trace_mod.TraceConfig,
                             mesh, go_camera: bool = True,
                             px_capacity: int = 0,
                             split: Optional[object] = None):
    """The compacted wavefront (the kernels), sharded over the ``px`` axis.

    Each px shard owns a band of height / px rows and runs the single-card
    pipeline on it: the mask of its band (``megakernel.pixel_mask`` with a
    row band: K2, K6 or K6-stream tiling those rows alone), the pixel
    compaction into the STATIC capacity ``px_capacity`` (default half the
    band's pixels), the trace kernels (K1, K3+K4, K5 or K7) through the
    split ladder, and the segment-add into its band image. No traffic
    between shards during the frame and no host read: the overflow stays a
    0-d tensor on the device, summed over the shards (and across
    processes), and the caller must check it. overflow > 0 means a
    capacity was short:

    * a shard had more hit pixels than ``px_capacity``: render again with
      a larger one;
    * a ladder level kept more survivors than its capacity: render again
      with ``split=0``. As in the JAX package the caller owns the retry.

    The ladder gets an explicit survivor capacity a chunk
    (``renderer._auto_surv_cap``, as ``render_wavefront`` does). (The JAX
    function passes surv_cap=0, which its ladder turns into a capacity of
    the whole chunk, so its ladder can never report an overflow.)
    ``split=None`` uses ``renderer.pick_split``. ``sp`` must be 1 and the
    height a multiple of px.

    Returns (image (H, W, 3), overflow), both on the mesh's home device;
    under a process group every process receives the whole image."""
    n_shards = mesh.shape["px"]
    if mesh.shape.get("sp", 1) != 1:
        raise ValueError("render_wavefront_sharded shards pixels only; "
                         "build the mesh with sp=1")
    if height % n_shards:
        raise ValueError(f"height {height} must divide the px axis "
                         f"({n_shards}) for the sharded wavefront")
    rows = height // n_shards
    if px_capacity <= 0:
        px_capacity = max(1, rows * width // 2)
    if split is None:
        split = renderer_mod.pick_split(scene, cfg)
    deep_caps = renderer_mod.pick_deep_caps(scene) if split else "const"
    home = mesh.home
    img = torch.zeros((height, width, 3), dtype=torch.float32, device=home)
    overflow = torch.zeros((), dtype=torch.int64, device=home)
    scenes = _Scenes(scene)
    for i, _ in mesh.local_coords():
        part, ov = _band_wavefront(
            scenes.on(mesh.devices[i, 0]), i * rows, rows, width=width,
            height=height, samples=samples, cfg=cfg, go_camera=go_camera,
            px_capacity=px_capacity, split=split, deep_caps=deep_caps)
        img[i * rows:(i + 1) * rows] = part.to(home)
        overflow += ov.to(home)
    return _all_sum(img, mesh), _all_sum(overflow, mesh)


def render_linear_sharded(scene, width: int, height: int, *, samples: int,
                          cfg: trace_mod.TraceConfig, mesh,
                          go_camera: bool = True,
                          band_h: Optional[int] = None) -> np.ndarray:
    """The whole image by ``render_band_sharded``, in a host loop over row
    bands: (H, W, 3) float32 numpy, on every process. The band height
    (``renderer.pick_band_height`` at the samples of one coordinate) keeps
    each coordinate's wavefront under the lane budget: more coordinates,
    taller bands, fewer steps. A ragged last band renders at full height
    and keeps its new rows."""
    n_dev = mesh.shape["px"] * mesh.shape["sp"]
    bh = band_h or renderer_mod.pick_band_height(
        width, height, max(1, samples // n_dev), n_prims=scene.prim_count)
    bh = min(bh, height)
    out = np.zeros((height, width, 3), np.float32)
    for y0 in range(0, height, bh):
        top = min(y0, height - bh)
        band = render_band_sharded(scene, top, width=width, height=height,
                                   band_h=bh, samples=samples, cfg=cfg,
                                   mesh=mesh, go_camera=go_camera)
        out[top:top + bh] = band.cpu().numpy()
    return out
