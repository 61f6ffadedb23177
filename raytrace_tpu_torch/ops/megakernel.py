"""The kernels of the main path, each beside its plain PyTorch version.

Port of the host side of ``raytrace_tpu/ops/megakernel.py``:

* ``trace`` - the bounce megakernel (``trace_pallas`` :2987), by the
  scene's kernel mode: K1 in ``unroll`` mode (scenes of at most 96
  primitives, 48 with vertex normals; CUDA source ``csrc/trace_unroll.cu``),
  K3+K4 in ``bvh`` mode (97-4096 primitives with a scene BVH: the
  closest-hit and hard-shadow tree walks, K3, and the fused soft-shadow
  walk, K4, in one launch; ``csrc/trace_bvh.cu``), K5 in ``stream`` mode
  (4097-262,144 primitives with a scene BVH: the same walks over the
  unified leaf rows of ``pack_stream_table``; ``csrc/trace_stream.cu``),
  or K7 in ``loop`` mode (past the unroll limit without a BVH: brute force
  over tables of any size; ``csrc/trace_loop.cu``). All four run the one
  bounce body of ``csrc/bounce.cuh`` with the extended features (K1-ext:
  smooth normals, material kinds 7-12, textures) and the resumable form
  (K1-state: ``start_bounce``/``end_bounce``, the initial throughput and
  alive flags, and the state after the segment). In bvh and stream
  modes the walks take the 4-wide layout where ``bvh.wide_walk`` says the
  JAX kernel would (K3-wide), else the binary tree. Plain version:
  ``trace.trace``, which in bvh and stream modes walks the tree once per
  ray (``bvh.traverse_closest_wide`` or ``traverse_closest``, and
  ``traverse_any``).
* K2, K6 and K6-stream, ``pixel_mask`` - the per-pixel conservative hit
  mask (``pixel_mask_pallas`` :2532): brute force over bounding spheres
  (K2, unroll and loop modes), a walk over cone-inflated node slabs with
  bounding-sphere tests at the leaves (K6, bvh mode), or the same walk
  that marks a pixel at the first leaf slab it reaches (K6-stream, stream
  mode). CUDA source: ``csrc/pixel_mask.cu``. Plain version:
  ``pixel_mask_plain``.

A wrapper takes its plain version only for a scene or tensor on the CPU;
on a CUDA device it launches its kernel or raises - there is no fallback.
Each wrapper counts its launches in ``LAUNCHES``, adding one where it
launches its kernel and nowhere else; a trace launch that resumes or
returns lane state also counts under ``trace_state`` (K1-state), and one
whose walks take the 4-wide table under ``trace_wide`` (K3-wide).

Past ``MAX_STREAM_KERNEL_PRIMS`` primitives the JAX package renders with
its banded jnp engine, which is not ported: such scenes raise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import bvh as bvh_mod
from .. import scene as scene_mod
from .. import trace as trace_mod
from .._f32 import sqrt as _sqrt
from ..camera import lookat_basis
from ..models import textures as tex_mod
from . import _build

UNROLL_PRIM_LIMIT = 96
UNROLL_PRIM_LIMIT_VN = scene_mod.UNROLL_PRIM_LIMIT_VN  # 48
MAX_BVH_KERNEL_PRIMS = scene_mod.MAX_BVH_KERNEL_PRIMS  # 4096
MAX_STREAM_KERNEL_PRIMS = 1 << 18
# Floats of a unified stream row: [tag, v0 or center.xyz, e1.xyz (radius
# in e1.x), e2.xyz, normal.xyz, mat], + 9 vertex-normal floats in a
# smooth-shaded scene. (The JAX package pads rows to 128 floats, a TPU
# tile rule; the port keeps them narrow.)
STREAM_COLS = 14
STREAM_COLS_VN = 23
# K7 copies its tables to shared memory up to this many bytes (the most a
# block takes without opting in); past it they stay in global memory.
LOOP_SMEM_BYTES = 48 * 1024
COUNTERS = 5              # rt::kBruteCounters: per-lane work of K1 and K7
BVH_COUNTERS = 10         # rt::kBvhCounters: per-lane work of K3+K4, K5
STATE_COLS = 10           # resumable lane state: origin, direction,
                          # throughput, alive (trace.state_dict)
# The kernels' tables, in the order of csrc/bounce.cuh
ORDER = ("sph", "tri", "pln", "box", "lit", "mat", "tex", "aux")
KERNELS = {"unroll": "trace_unroll", "bvh": "trace_bvh",
           "stream": "trace_stream", "loop": "trace_loop"}
MASKS = {"unroll": "pixel_mask", "loop": "pixel_mask",
         "bvh": "pixel_mask_bvh", "stream": "pixel_mask_stream"}

# Kernel launches since the last reset_launches(), by kernel;
# "trace_state" counts the trace launches that take or return lane state,
# "trace_wide" those whose walks take the 4-wide table.
LAUNCHES = {"trace_unroll": 0, "trace_bvh": 0, "trace_stream": 0,
            "trace_loop": 0, "trace_state": 0, "trace_wide": 0,
            "pixel_mask": 0,
            "pixel_mask_bvh": 0, "pixel_mask_stream": 0}

def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scene_fits_kernel(scene) -> bool:
    """Does a kernel mode of the JAX package take this scene?"""
    n = scene.prim_count
    if n <= UNROLL_PRIM_LIMIT:
        return True
    return scene.accel is not None and n <= MAX_STREAM_KERNEL_PRIMS


def _kernel_mode(scene) -> str:
    """'unroll' | 'bvh' | 'stream' | 'loop' by primitive count (spheres +
    triangles + planes), as in the JAX package: unroll up to 96 (48 in a
    smooth-shaded scene); past it bvh up to 4096 and stream beyond when
    the scene has a BVH, else loop."""
    n = scene.prim_count
    limit = UNROLL_PRIM_LIMIT
    if scene.geometry.tri_vn is not None:
        limit = min(limit, UNROLL_PRIM_LIMIT_VN)
    if n <= limit:
        return "unroll"
    if scene.accel is not None:
        return "bvh" if n <= MAX_BVH_KERNEL_PRIMS else "stream"
    return "loop"


def require_mode(scene) -> str:
    """The scene's kernel mode; raises NotImplementedError past
    MAX_STREAM_KERNEL_PRIMS primitives with a BVH, where the JAX Renderer
    leaves its kernels for the banded jnp engine (raytrace_tpu/renderer.py
    :917-930), which the port has not ported."""
    mode = _kernel_mode(scene)
    if mode == "stream" and scene.prim_count > MAX_STREAM_KERNEL_PRIMS:
        raise NotImplementedError(
            f"scene has {scene.prim_count} primitives: past "
            f"{MAX_STREAM_KERNEL_PRIMS} the JAX package renders with its "
            "banded jnp engine (raytrace_tpu/renderer.py:917-930), which "
            "is not ported yet: ROADMAP Queue 1, the past-cap band route")
    return mode


def pack_stream_table(scene) -> torch.Tensor:
    """(P + leaf_size, C) float32 unified primitive rows in leaf order:
    K5's leaf table (``pack_stream_table`` :2893).

    Row (STREAM_COLS, or STREAM_COLS_VN with vertex normals): col 0 the
    tag - 0 sphere, 1 triangle, 2 cube-face triangle (in the tree, which
    bounds it for the masks; every trace walk skips it, as boxes own a
    cube's closest hit and occlusion), -1 padding; cols 1-13
    the triangle layout (v0.xyz, e1.xyz, e2.xyz, normal.xyz, mat), a
    sphere with its center in the v0 slot, its radius in e1.x and its mat
    in col 13; cols 14-22 the vertex normals n0, n1, n2. Rows are
    permuted by the tree's prim_index, so a leaf's primitives are the
    rows [first, first + count), and leaf_size rows of tag -1 follow."""
    g, accel = scene.geometry, scene.accel
    dev = g.sph_center.device
    f = lambda x: x.to(torch.float32)
    z = lambda n, c: torch.zeros((n, c), dtype=torch.float32, device=dev)
    ns, nt = g.sph_center.shape[0], g.tri_v0.shape[0]
    has_vn = g.tri_vn is not None
    cols = STREAM_COLS_VN if has_vn else STREAM_COLS
    parts = []
    if ns:
        parts.append(torch.cat([z(ns, 1), f(g.sph_center),
                                f(g.sph_radius)[:, None], z(ns, 8),
                                f(g.sph_mat)[:, None]]
                               + ([z(ns, 9)] if has_vn else []), 1))
    if nt:
        v0 = f(g.tri_v0)
        tag = torch.where(torch.arange(nt, device=dev) < g.n_hit_tris,
                          1.0, 2.0)[:, None]
        parts.append(torch.cat([tag, v0, f(g.tri_v1) - v0, f(g.tri_v2) - v0,
                                f(g.tri_normal), f(g.tri_mat)[:, None]]
                               + ([f(g.tri_vn)] if has_vn else []), 1))
    rows = torch.cat(parts, 0)[accel.prim_index.to(torch.int64)]
    leaf = int(accel.leaf_size)
    pad = torch.cat([torch.full((leaf, 1), -1.0, device=dev),
                     z(leaf, cols - 1)], 1)
    return torch.cat([rows, pad], 0).contiguous()


def with_stream_table(scene):
    """The scene with its stream table on the accel: packed at build time
    (scene._attach_stream_table), or now for a scene whose accel was
    attached by hand. The plain stream walks and K5 read it."""
    if scene.accel is None or scene.accel.stream_tab is not None:
        return scene
    return dataclasses.replace(scene, accel=dataclasses.replace(
        scene.accel, stream_tab=pack_stream_table(scene)))


def pack_tables(scene, prims: bool = True):
    """Row-major float32 tables of the kernels (one row per item):
    sph (Ns,5), tri (Nt_hit,13) or with vertex normals (Nt_hit,22),
    pln (Np,7), box (Nb,7), lit (L,7), mat (M,14) or with an extended kind
    (M,19), and the texture table: tex (T,16) and its aux rows (A,3).
    ``tri`` holds the hit triangles only: cube faces are hit as their
    boxes. Column layouts are those of ``csrc/bounce.cuh`` and
    ``csrc/textures.cuh``. ``prims`` False leaves sph and tri empty (stream
    mode reads its spheres and triangles from the stream table)."""
    g, m, lt = scene.geometry, scene.materials, scene.lights
    nt = g.n_hit_tris if prims else 0
    ns = g.sph_center.shape[0] if prims else 0
    v0 = g.tri_v0[:nt]
    f = lambda x: x.to(torch.float32)
    col = lambda x: f(x)[:, None]
    tri = [v0, g.tri_v1[:nt] - v0, g.tri_v2[:nt] - v0, g.tri_normal[:nt],
           col(g.tri_mat[:nt])]
    if g.tri_vn is not None:
        tri.append(g.tri_vn[:nt])
    mat = [col(m.kind), m.albedo, m.roughness[:, None], m.metallic[:, None],
           m.specular[:, None], m.ior[:, None], m.emit, m.eff_albedo]
    if m.has_advanced:
        mat += [m.aux_vec, m.aux_a[:, None], m.aux_b[:, None]]
    tex, aux = tex_mod.texture_rows(m.textures)
    return dict(
        sph=torch.cat([g.sph_center[:ns], g.sph_radius[:ns, None],
                       col(g.sph_mat[:ns])], 1),
        tri=torch.cat(tri, 1),
        pln=torch.cat([g.pl_point, g.pl_normal, col(g.pl_mat)], 1),
        box=torch.cat([g.box_min, g.box_max, col(g.box_mat)], 1),
        lit=torch.cat([lt.position, lt.color, lt.intensity[:, None]], 1),
        mat=torch.cat(mat, 1),
        tex=tex.to(scene.device),
        aux=aux.to(scene.device),
    )


def loop_tables_in_smem(tabs) -> bool:
    """Does K7 take these tables (``pack_tables``) into shared memory?"""
    return 4 * sum(tabs[k].numel() for k in ORDER) <= LOOP_SMEM_BYTES


def _affine_camera(scene, go_camera: bool) -> torch.Tensor:
    """(4,3) [origin, A, B, C]: direction = A + u*B + v*C (both cameras
    are affine in u, v)."""
    cam = scene.camera
    if go_camera:
        vp_w = 2.0 * cam.aspect_ratio
        zero = torch.zeros_like(vp_w)
        B = torch.stack([vp_w, zero, zero])
        C = torch.tensor([0.0, 2.0, 0.0], device=vp_w.device)
        A = -B / 2.0 - C / 2.0 - torch.tensor([0.0, 0.0, 1.0],
                                              device=vp_w.device)
    else:
        fwd, right, up, half_w, half_h = lookat_basis(cam)
        A = fwd - half_w * right - half_h * up
        B = 2.0 * half_w * right
        C = 2.0 * half_h * up
    return torch.stack([cam.position, A, B, C]).to(torch.float32)


def _bsphere_table(scene) -> torch.Tensor:
    """(Ns+Nt, 4) [center.xyz, radius]: the spheres, then every triangle's
    bounding sphere (centroid, farthest vertex) - cube faces included,
    which is how the mask covers boxes."""
    g = scene.geometry
    m = (g.tri_v0 + g.tri_v1 + g.tri_v2) * (1.0 / 3.0)

    def sq(v):
        dv = v - m
        return dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1] + dv[:, 2] * dv[:, 2]

    rt = _sqrt(torch.maximum(torch.maximum(sq(g.tri_v0), sq(g.tri_v1)),
                             sq(g.tri_v2)))
    c = torch.cat([g.sph_center, m], 0)
    r = torch.cat([g.sph_radius, rt], 0)
    return torch.cat([c, r[:, None]], 1)


def _cone_half_sin(cam4: torch.Tensor, width: int,
                   height: int) -> torch.Tensor:
    """Bound on sin(angle) between any jittered ray of a pixel and its
    center ray: 0.5 * (|B|/W + |C|/H), as a float32 scalar tensor."""
    b, c = cam4[2], cam4[3]
    nb = _sqrt(b[0] * b[0] + b[1] * b[1] + b[2] * b[2])
    nc = _sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])
    return 0.5 * (nb / width + nc / height)


def pack_bvh_tables(accel, inflate: float = 0.0):
    """FlatBVH -> (nodes (N,9), prim_index (P,)) float32 tables.

    Node row: [min.xyz, max.xyz, skip, first, count] (the int fields are
    exact in float32 up to 2^24). ``inflate`` grows each box by
    inflate * extent + inflate per side."""
    nmin, nmax = accel.node_min, accel.node_max
    if inflate > 0.0:
        pad = inflate * (nmax - nmin) + inflate
        nmin = nmin - pad
        nmax = nmax + pad
    col = lambda x: x.to(torch.float32)[:, None]
    nodes = torch.cat([nmin, nmax, col(accel.node_skip),
                       col(accel.node_first), col(accel.node_count)], 1)
    return nodes, accel.prim_index.to(torch.float32)


def _mask_tree(scene, cam4, k):
    """K6's tables: (nodes (N,9), prim_index (P,)), every node slab grown
    by the jitter cone at its farthest corner, k * |origin - corner| +
    eps, plus the fp slack 1e-3 * extent + 1e-3 (the bvh branch of
    pixel_mask_pallas, :2777)."""
    eps = 1e-3
    nodes, pidx = pack_bvh_tables(scene.accel)
    nmin, nmax = nodes[:, 0:3], nodes[:, 3:6]
    o = cam4[0]
    far = torch.maximum(torch.abs(nmin - o), torch.abs(nmax - o))
    d_far = _sqrt(far[:, 0] * far[:, 0] + far[:, 1] * far[:, 1]
                  + far[:, 2] * far[:, 2])
    padn = (k * d_far + eps)[:, None]
    fp = 1e-3 * (nmax - nmin) + 1e-3
    return (torch.cat([nmin - padn - fp, nmax + padn + fp, nodes[:, 6:]],
                      1), pidx)


def _mask_inputs(scene, width, height, cfg, go_camera):
    """(mode, affine camera (4,3), cone bound k, bounding spheres (Nbs,4)
    or None in stream mode, planes (Np,7), and in bvh and stream modes
    the walk's (nodes, prim_index))."""
    if cfg.depth_of_field:
        raise NotImplementedError(
            "the mask's thin-lens DoF slack is not ported yet (and the "
            "JAX kernel's is not conservative): ROADMAP Queue 1 item 3 and "
            "Queue 3")
    mode = require_mode(scene)
    cam4 = _affine_camera(scene, go_camera)
    k = _cone_half_sin(cam4, width, height)
    g = scene.geometry
    pln = torch.cat([g.pl_point, g.pl_normal,
                     g.pl_mat[:, None].to(torch.float32)], 1)
    tree = _mask_tree(scene, cam4, k) if mode in ("bvh", "stream") else None
    # stream scenes: the mask stops at the node slabs (node_only, :2597)
    bs = None if mode == "stream" else _bsphere_table(scene)
    return mode, cam4, k, bs, pln, tree


# ------------------------------------------------ K2, K6, K6-stream ----

def _bs_hit(o, dx, dy, dz, inv_a, sqa, k, bs):
    """The cone-inflated bounding-sphere test of ``csrc/pixel_mask.cu``
    (``bs_hit``): rows bs (..., 4) against center rays whose direction
    components (and inv_a = 1/|d|^2, sqa = |d|) broadcast against them."""
    oc = bs[..., :3] - o
    ocx, ocy, ocz = oc[..., 0], oc[..., 1], oc[..., 2]
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    g = ocx * dx + ocy * dy + ocz * dz
    r = bs[..., 3]
    R = r + (_sqrt(oc2) + r) * k + 1e-3
    return (oc2 - g * g * inv_a <= R * R) & (g >= -R * sqa)


def _mask_walk(o, d, inv_a, sqa, k, bs, nodes, pidx, leaf_size, work):
    """(P,) bool: K6's walk for every pixel's center ray. Skip walk over
    the inflated slabs (near clamped at 0); a boxed leaf runs the
    bounding-sphere test of its primitives, or, with ``bs`` None (K6-stream,
    the node-only branch), marks the pixel at once; a pixel stops at its
    first hit. ``work`` (a list of two ints, or None) gets the node slab
    tests and the bounding-sphere tests added to it."""
    P, n = d.shape[0], nodes.shape[0]
    iv = 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-30), d)
    lo, hi = nodes[:, 0:3], nodes[:, 3:6]
    skip, first, cnt = (nodes[:, c].to(torch.int64) for c in (6, 7, 8))
    slots = torch.arange(leaf_size, device=d.device)
    hit = torch.zeros(P, dtype=torch.bool, device=d.device)
    cursor = torch.zeros(P, dtype=torch.int64, device=d.device)
    act = torch.arange(P, device=d.device)
    while act.numel():
        if work is not None:
            work[0] += act.numel()
        cur = cursor[act]
        t0 = (lo[cur] - o) * iv[act]
        t1 = (hi[cur] - o) * iv[act]
        tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = torch.maximum(torch.maximum(tn[:, 0], tn[:, 1]),
                             torch.clamp(tn[:, 2], min=0.0))
        far = torch.minimum(torch.minimum(tf[:, 0], tf[:, 1]), tf[:, 2])
        boxed = near <= far
        leaf = cnt[cur] > 0
        if bs is None:
            h = boxed & leaf
        else:
            at = (boxed & leaf).nonzero()[:, 0]
            h = torch.zeros_like(boxed)
            if at.numel():
                c = cur[at]
                slot = torch.clamp(first[c][:, None] + slots,
                                   max=pidx.shape[0] - 1)
                rows = bs[pidx[slot].to(torch.int64)]          # (A,L,4)
                valid = slots < cnt[c][:, None]
                if work is not None:
                    work[1] += int(valid.sum())
                lane = act[at]
                dd = d[lane]
                h[at] = torch.any(
                    _bs_hit(o, dd[:, 0:1], dd[:, 1:2], dd[:, 2:3],
                            inv_a[lane], sqa[lane], k, rows) & valid,
                    dim=-1)
        hit[act[h]] = True
        nxt = torch.where(boxed & ~leaf, cur + 1, skip[cur])
        nxt = torch.where(h, n, nxt)
        cursor[act] = nxt
        act = act[nxt < n]
    return hit


def pixel_mask_plain(scene, *, width: int, height: int, cfg,
                     go_camera: bool = True, work=None) -> torch.Tensor:
    """The plain version of K2 (unroll and loop modes), K6 (bvh mode) and
    K6-stream (stream mode): (H*W,) bool, the same float32 operations as
    ``csrc/pixel_mask.cu``, vectorised over pixels. ``work``: see
    _mask_walk (bvh and stream modes)."""
    mode, cam4, k, bs, pln, tree = _mask_inputs(scene, width, height, cfg,
                                                go_camera)
    dev = scene.device
    eps = 1e-3
    inv_w = float(np.float32(1.0 / width))
    inv_h = float(np.float32(1.0 / height))
    pix = torch.arange(width * height, device=dev)
    u = ((pix % width).to(torch.float32) + 0.5) * inv_w
    v = ((pix // width).to(torch.float32) + 0.5) * inv_h
    o = cam4[0]
    d = cam4[1] + u[:, None] * cam4[2] + v[:, None] * cam4[3]   # (P,3)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    sqa = _sqrt(a)
    hit = torch.zeros((width * height,), dtype=torch.bool, device=dev)
    if tree is not None:
        hit |= _mask_walk(o, d, inv_a, sqa, k, bs, *tree,
                          scene.accel.leaf_size, work)
    elif bs.shape[0]:
        hit |= torch.any(_bs_hit(o, dx, dy, dz, inv_a, sqa, k, bs[None]),
                         dim=-1)
    if pln.shape[0]:
        n = pln[None, :, 3:6]
        denom = dx * n[..., 0] + dy * n[..., 1] + dz * n[..., 2]
        pd = pln[None, :, 0:3] - o
        num = (pd[..., 0] * n[..., 0] + pd[..., 1] * n[..., 1]
               + pd[..., 2] * n[..., 2])
        hit |= torch.any((torch.abs(denom) <= k + eps) | (num * denom > 0.0)
                         | (torch.abs(num) <= eps), dim=-1)
    return hit


def prepare_pixel_mask(scene, *, width: int, height: int, cfg,
                       go_camera: bool = True):
    """The mask kernel's inputs on the card: returns (out, launch).
    ``launch()`` runs K2 (unroll and loop modes), K6 (bvh mode) or
    K6-stream (stream mode) into ``out``, (H*W,) bool, and counts the
    launch under the kernel's name (``MASKS``)."""
    dev = scene.device
    if dev.type != "cuda":
        raise RuntimeError(f"pixel_mask kernel: device {dev} is not CUDA")
    mode, cam4, k, bs, pln, tree = _mask_inputs(scene, width, height, cfg,
                                                go_camera)
    name = MASKS[mode]
    cam = torch.cat([cam4.reshape(-1), k.reshape(1)]).contiguous()
    pln = pln.contiguous()
    out = torch.empty((width * height,), dtype=torch.bool, device=dev)
    lib = _build.library()
    inv_w = float(np.float32(1.0 / width))
    inv_h = float(np.float32(1.0 / height))
    # the kernel's arguments after ``out``; tensors stay referenced here
    # until the launch reads their pointers
    head = (width, height, inv_w, inv_h, cam)
    tail = (pln, pln.shape[0])
    if mode == "stream":
        nodes = tree[0].contiguous()
        args = head + (nodes, nodes.shape[0]) + tail
    elif mode == "bvh":
        nodes, pidx = (t.contiguous() for t in tree)
        args = head + (bs.contiguous(), nodes, nodes.shape[0], pidx) + tail
    else:
        args = head + (bs.contiguous(), bs.shape[0]) + tail
    entry = getattr(lib, "rt_" + name)

    def launch():
        err = entry(out.data_ptr(), *(
            a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, name)
        LAUNCHES[name] += 1

    return out, launch


def pixel_mask(scene, *, width: int, height: int, cfg,
               go_camera: bool = True) -> torch.Tensor:
    """(H*W,) bool conservative per-pixel hit mask on the scene's device:
    K2, K6 or K6-stream on CUDA, their plain version on the CPU."""
    if scene.device.type == "cpu":
        return pixel_mask_plain(scene, width=width, height=height, cfg=cfg,
                                go_camera=go_camera)
    out, launch = prepare_pixel_mask(scene, width=width, height=height,
                                     cfg=cfg, go_camera=go_camera)
    launch()
    return out


# --------------------------------------------- K1, K3+K4, K5, K7 ----

def _check_trace_inputs(scene, origin, direction, pix_id, samp_id, cfg,
                        init_throughput=None, init_alive=None):
    """Raises for inputs the trace kernels cannot take; returns the
    scene's kernel mode."""
    trace_mod.check_supported(cfg)
    mode = require_mode(scene)
    n = origin.shape[0]
    for name, t, shape in (("origin", origin, (n, 3)),
                           ("direction", direction, (n, 3)),
                           ("pix_id", pix_id, (n,)),
                           ("samp_id", samp_id, (n,)),
                           ("init_throughput", init_throughput, (n, 3)),
                           ("init_alive", init_alive, (n,))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.device != scene.device:
            raise ValueError(f"{name} is on {t.device}, the scene on "
                             f"{scene.device}")
    return mode


def trace_tables(scene, mode):
    """The trace kernel's scene input: (flat float32 tables in the order of
    ``csrc/bounce.cuh``, then in bvh and stream modes the node table, the
    4-wide table when the walks take it (``bvh.wide_walk``; else n_wide is
    0 and they walk the binary tree) and in bvh mode prim_index; the table
    sizes as ``bounce.cuh:Dims``; and
    ``extra``: in loop mode whether K7 takes the tables into shared
    memory, in stream mode the stream table, which K5 reads in place).

    In stream mode the sphere and triangle tables are left out (ns = nt =
    0): K5 reads every sphere and triangle from the stream table, whose
    rows are tri_cols + 1 floats wide."""
    tabs = pack_tables(scene, prims=mode != "stream")
    extra = None
    tri_cols = tabs["tri"].shape[1] if tabs["tri"].shape[0] else 13
    if mode == "stream":
        tri_cols = (STREAM_COLS_VN if scene.geometry.tri_vn is not None
                    else STREAM_COLS) - 1
        extra = with_stream_table(scene).accel.stream_tab
    dims = [tabs[k].shape[0] for k in ORDER[:6]] + [
        tri_cols, tabs["mat"].shape[1], tabs["tex"].shape[0],
        tabs["aux"].shape[0]]
    parts = [tabs[k].reshape(-1) for k in ORDER]
    if mode in ("bvh", "stream"):
        accel = scene.accel if mode == "bvh" else with_stream_table(
            scene).accel
        nodes, pidx = pack_bvh_tables(accel)
        parts.append(nodes.reshape(-1))
        n_wide = 0
        if bvh_mod.wide_walk(accel):   # K3-wide: the 4-wide table
            parts.append(accel.wide4.reshape(-1))
            n_wide = accel.wide4.shape[0]
        if mode == "bvh":
            parts.append(pidx)
        dims += [nodes.shape[0], accel.leaf_size, n_wide]
    else:
        dims += [0, 0, 0]
    if mode == "loop":
        extra = loop_tables_in_smem(tabs)
    return torch.cat(parts).contiguous(), dims, extra


def prepare_trace(scene, origin, direction, pix_id, samp_id, cfg,
                  *, start_bounce: int = 0, end_bounce=None,
                  init_throughput=None, init_alive=None,
                  return_state: bool = False,
                  counters: torch.Tensor | None = None):
    """The trace kernel's inputs on the card: returns (out, launch).
    ``launch()`` runs K1 (unroll mode), K3+K4 (bvh mode), K5 (stream mode)
    or K7 (loop mode) into ``out`` and counts the launch under the
    kernel's name (``KERNELS``), under ``trace_state`` too when it
    resumes or returns lane state (K1-state), and under ``trace_wide`` when
    its walks take the 4-wide table (K3-wide).

    ``out`` is (B,3) float32 radiance, or with ``return_state`` the pair
    (radiance, state) of ``trace.trace``. ``start_bounce``, ``end_bounce``,
    ``init_throughput`` and ``init_alive`` are those of ``trace.trace``.

    ``counters`` (for operation counts; off on the main path) receives
    each lane's work. Unroll and loop modes, (B, COUNTERS) int32:
    closest-hit rays, hard and soft shadow rays, and occlusion tests of
    spheres+planes and of triangles+boxes. Bvh and stream modes, (B,
    BVH_COUNTERS) int32: closest-hit, hard shadow and soft shadow rays,
    then node slab tests, sphere tests and triangle tests of the
    closest-hit and hard shadow walks, node slab tests and (sample,
    primitive) tests of the fused soft walks, and brute-force plane and
    box tests."""
    dev = scene.device
    if dev.type != "cuda":
        raise RuntimeError(f"trace kernel: device {dev} is not CUDA")
    mode = _check_trace_inputs(scene, origin, direction, pix_id, samp_id,
                               cfg, init_throughput, init_alive)
    kernel = KERNELS[mode]
    n_counters = BVH_COUNTERS if mode in ("bvh", "stream") else COUNTERS
    n = origin.shape[0]
    o = origin.to(torch.float32).contiguous()
    d = direction.to(torch.float32).contiguous()
    pix = pix_id.to(torch.int32).contiguous()
    samp = samp_id.to(torch.int32).contiguous()
    tp = al = state = None
    if init_throughput is not None:
        tp = init_throughput.to(torch.float32).contiguous()
    if init_alive is not None:
        al = init_alive.to(torch.float32).contiguous()
    if return_state:
        state = torch.empty((n, STATE_COLS), dtype=torch.float32,
                            device=dev)
    stateful = (return_state or start_bounce > 0 or tp is not None
                or al is not None)
    end = cfg.max_depth if end_bounce is None else min(end_bounce,
                                                       cfg.max_depth)
    ptr = lambda t: None if t is None else t.data_ptr()
    flat, dims, extra = trace_tables(scene, mode)
    wide = dims[12] > 0
    rad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if counters is not None and (
            tuple(counters.shape) != (n, n_counters)
            or counters.dtype != torch.int32 or counters.device != dev
            or not counters.is_contiguous()):
        raise ValueError(f"counters must be a contiguous (B,{n_counters}) "
                         "int32 tensor on the scene's device")
    lib = _build.library()
    entry = getattr(lib, "rt_" + kernel)
    dims_c = (ctypes.c_int * len(dims))(*dims)
    if mode == "loop":
        extra_args = (int(extra),)
    elif mode == "stream":
        extra_args = (extra,)  # the stream table: K5 reads it in place
    else:
        extra_args = ()

    def launch():
        err = entry(
            o.data_ptr(), d.data_ptr(), pix.data_ptr(), samp.data_ptr(),
            ptr(tp), ptr(al), rad.data_ptr(), ptr(state), ptr(counters), n,
            flat.data_ptr(), dims_c, *(ptr(a) if isinstance(a, torch.Tensor)
                                       else a for a in extra_args),
            start_bounce, end,
            cfg.shadow_samples, int(cfg.soft_shadows),
            int(cfg.recursive_reflections), cfg.seed & 0xFFFFFFFF,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, kernel)
        LAUNCHES[kernel] += 1
        if stateful:
            LAUNCHES["trace_state"] += 1
        if wide:
            LAUNCHES["trace_wide"] += 1

    out = (rad, trace_mod.state_dict(state)) if return_state else rad
    return out, launch


def trace(scene, origin, direction, pix_id, samp_id, cfg, *,
          start_bounce: int = 0, end_bounce=None, init_throughput=None,
          init_alive=None, return_state: bool = False):
    """Trace lanes: radiance (B,3) float32, or with ``return_state`` the
    pair (radiance, state) - see ``trace.trace`` for the resumable form.

    On CUDA, K1 (unroll mode), K3+K4 (bvh mode), K5 (stream mode) or K7
    (loop mode) by the scene's kernel mode; on the CPU their plain version
    ``trace.trace`` (which walks the tree, or in stream mode the stream
    table's leaf rows, once per ray). origin/direction: (B,3) float32;
    pix_id/samp_id: (B,) integer lane ids (uint32 values).
    """
    kw = dict(start_bounce=start_bounce, end_bounce=end_bounce,
              init_throughput=init_throughput, init_alive=init_alive,
              return_state=return_state)
    if scene.device.type == "cpu":
        mode = _check_trace_inputs(scene, origin, direction, pix_id,
                                   samp_id, cfg, init_throughput, init_alive)
        if mode == "stream":
            scene = with_stream_table(scene)
        return trace_mod.trace(scene, origin, direction, pix_id, samp_id,
                               cfg, **kw)
    out, launch = prepare_trace(scene, origin, direction, pix_id, samp_id,
                                cfg, **kw)
    launch()
    return out
