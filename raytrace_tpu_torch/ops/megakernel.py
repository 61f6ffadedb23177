"""The kernels of the main path, each beside its plain PyTorch version.

Port of the host side of ``raytrace_tpu/ops/megakernel.py``:

* ``trace`` - the bounce megakernel (``trace_pallas`` :2987), by the
  scene's kernel mode: K1 in ``unroll`` mode (scenes of at most 96
  primitives, 48 with vertex normals; CUDA source ``csrc/trace_unroll.cu``),
  K3+K4 in ``bvh`` mode (97-4096 primitives with a scene BVH: the
  closest-hit and hard-shadow tree walks, K3, and the fused soft-shadow
  walk, K4, in one launch; ``csrc/trace_bvh.cu``), K5 in ``stream`` mode
  (more than 4096 primitives with a scene BVH: the same walks over the
  unified leaf rows of ``pack_stream_table``, the closest-hit walk testing
  each leaf with the warp's lanes in the same walk;
  ``csrc/trace_stream.cu`` and ``csrc/stream_walk.cuh``),
  or K7 in ``loop`` mode (past the unroll limit without a BVH: brute force
  over tables of any size; ``csrc/trace_loop.cu``). K1, K3+K4 and K7 run
  persistent blocks that copy their table into shared memory once and
  take lanes from a counter (``csrc/common.cuh``). All four run the one
  bounce body of ``csrc/bounce.cuh`` with the extended features (K1-ext:
  smooth normals, material kinds 7-12, textures) and the resumable form
  (K1-state: ``start_bounce``/``end_bounce``, the initial throughput and
  alive flags, and the state after the segment), and with fast_mc
  (``cfg.russian_roulette_start``, ``cfg.throughput_epsilon``). In bvh and
  stream modes the walks take the 4-wide layout where ``bvh.wide_walk`` says the
  JAX kernel would (K3-wide), else the binary tree. Plain version:
  ``trace.trace``, which in bvh and stream modes walks the tree once per
  ray (``bvh.traverse_closest_wide`` or ``traverse_closest``, and
  ``traverse_any``).
* K2, K6 and K6-stream, ``pixel_mask`` - the per-pixel conservative hit
  mask (``pixel_mask_pallas`` :2532): brute force over bounding spheres
  (K2, unroll and loop modes), a walk over cone-inflated node slabs with
  bounding-sphere tests at the leaves (K6, bvh mode), or the same walk
  that marks a pixel at the first leaf slab it reaches (K6-stream, stream
  mode), each with a thin-lens branch for depth of field that takes the
  corrected bound (``_mask_camera``). All three run persistent blocks,
  each of which builds the camera row (``_mask_camera``'s, from the
  scene's camera tensors) and its table in its shared memory: K2 a leaf
  row a primitive with the per-pixel test's pixel-independent terms,
  tested to each pixel's first hit; K6 and K6-stream the grown node slabs
  and, for K6, a leaf row a slot, walked. Past ``MASK_SMEM_BYTES`` K2
  builds its rows a chunk at a time; for K6 and K6-stream a pre-pass
  writes the table to global memory and the walk reads it in place.
  CUDA source: ``csrc/pixel_mask.cu``. Plain versions:
  ``pixel_mask_plain``, ``k2_table_plain`` and ``mask_table_plain`` for
  the tables, ``_mask_camera`` for the camera row.
* K1-guard, in K1 and K7 (``csrc/brute_force.cuh``): the per-occluder
  cone guard of the soft-shadow loop, on every main-path launch
  (``soft_guard``), for any occluder count (in chunks of 96). Plain
  versions: ``soft_guard_mask`` and ``shadow_factor_guarded``
  (``shade.shadow_factor`` given the guard's flags), which the tests and
  chip_smoke.py hold the kernels to; the plain engine itself
  runs the unguarded loop, whose result is the same bit for bit.

A wrapper takes its plain version only for a scene or tensor on the CPU;
on a CUDA device it launches its kernel or raises - there is no fallback.
Each wrapper counts its launches in ``LAUNCHES``, adding one where it
launches its kernel and nowhere else; a trace launch that resumes or
returns lane state also counts under ``trace_state`` (K1-state), one
whose walks take the 4-wide table under ``trace_wide`` (K3-wide), a
K3+K4 launch that reads its walk table in place from global memory (past
``BVH_SMEM_BYTES``) under ``trace_bvh_ldg``, a K7 launch that reads its
tables in place (past ``LOOP_SMEM_BYTES``) under ``trace_loop_ldg``, a K1
or K7 launch with its soft-shadow guard under ``trace_guard``
(K1-guard), a mask launch with depth of field under ``mask_dof``, the
pre-pass under ``mask_table``, a mask launch that reads the pre-pass's
table in place (past ``MASK_SMEM_BYTES``) under ``pixel_mask_ldg``, a
K2 launch that builds its rows in more than one chunk under
``pixel_mask_chunked``, and the camera row's own launch (for the checks)
under ``mask_camera``.

Past ``MAX_STREAM_KERNEL_PRIMS`` primitives (the TPU kernel's cap, which
bounds a node table in the TPU's scalar memory) the JAX package leaves
its kernels for a banded jnp engine. K6-stream and K5 keep their tables
in global memory, so on the card such scenes stay in stream mode, up to
``MAX_STREAM_ROWS``, the stream kernels' own limit.
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
from .shade import shadow_factor as _shadow_factor  # before any swap

UNROLL_PRIM_LIMIT = 96
UNROLL_PRIM_LIMIT_VN = scene_mod.UNROLL_PRIM_LIMIT_VN  # 48
MAX_BVH_KERNEL_PRIMS = scene_mod.MAX_BVH_KERNEL_PRIMS  # 4096
MAX_STREAM_KERNEL_PRIMS = 1 << 18  # the JAX package's (scene_fits_kernel)
# The stream kernels' limit: the node table holds first, count, skip and
# child as float32 integers, exact up to 2^24 (csrc/trace_stream.cu).
MAX_STREAM_ROWS = 1 << 24
# Floats of a unified stream row: [tag, v0 or center.xyz, e1.xyz (radius
# in e1.x), e2.xyz, normal.xyz, mat], + 9 vertex-normal floats in a
# smooth-shaded scene. (The JAX package pads rows to 128 floats, a TPU
# tile rule; the port keeps them narrow.)
STREAM_COLS = 14
STREAM_COLS_VN = 23
# K3+K4 copies its walk table (pack_walk_table) to the shared memory of
# each block up to this many bytes (the most an H100 block can take, after
# opting in); past it the kernel reads the table in place.
BVH_SMEM_BYTES = 232_448
# K7's budget for its tables (pack_tables): the same bytes, K3+K4's; past
# it the tables stay in global memory and K7 reads them through __ldg.
LOOP_SMEM_BYTES = BVH_SMEM_BYTES
# K6 and K6-stream build their mask table (mask_table_plain) in the shared
# memory of each block up to this many bytes; past it (the past-cap
# grid's 393 KB table) the pre-pass writes it and the walk reads it in
# place.
MASK_SMEM_BYTES = BVH_SMEM_BYTES
MASK_NODE = 12            # floats of a mask-table node row (rt::kMaskNode)
MASK_LEAF = 8             # floats of a mask-table leaf row (rt::kMaskLeaf)
MASK_CAM = 20             # shared-memory floats of the camera row, which
                          # every mask block builds first (rt::kCamPad)
WALK_ROW = 12             # floats of a walk-table leaf row (rt::kWalkRow)
COUNTERS = 8              # rt::kBruteCounters: per-lane work of K1 and K7
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
# "trace_wide" those whose walks take the 4-wide table, "trace_bvh_ldg"
# the K3+K4 launches that read the walk table from global memory,
# "trace_loop_ldg" the K7 launches that read their tables from global
# memory, "trace_guard" the K1 and K7 launches with K1-guard on,
# "mask_dof" the mask launches with depth of field, "mask_table" the
# pre-pass launches, "pixel_mask_ldg" the mask launches that read the
# pre-pass's table from global memory, "pixel_mask_chunked" the K2
# launches that build their rows in more than one chunk (past
# MASK_SMEM_BYTES), "mask_camera" the launches of the camera row alone
# (``MaskLaunch.cam``, for the checks; on no main path).
LAUNCHES = {"trace_unroll": 0, "trace_bvh": 0, "trace_stream": 0,
            "trace_loop": 0, "trace_state": 0, "trace_wide": 0,
            "trace_bvh_ldg": 0, "trace_loop_ldg": 0,
            "trace_guard": 0, "pixel_mask": 0,
            "pixel_mask_bvh": 0, "pixel_mask_stream": 0, "mask_dof": 0,
            "mask_table": 0, "pixel_mask_ldg": 0, "pixel_mask_chunked": 0,
            "mask_camera": 0}

def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scene_fits_kernel(scene) -> bool:
    """Does a kernel mode of the JAX package take this scene? (Past
    MAX_STREAM_KERNEL_PRIMS the JAX Renderer takes its banded jnp engine;
    the port stays in stream mode, ``require_mode``.)"""
    n = scene.prim_count
    if n <= UNROLL_PRIM_LIMIT:
        return True
    return scene.accel is not None and n <= MAX_STREAM_KERNEL_PRIMS


def _kernel_mode(scene) -> str:
    """'unroll' | 'bvh' | 'stream' | 'loop' by primitive count (spheres +
    triangles + planes), as in the JAX package: unroll up to 96 (48 in a
    smooth-shaded scene); past it bvh up to 4096 and stream beyond when
    the scene has a BVH, else loop. (The JAX package's stream mode ends at
    MAX_STREAM_KERNEL_PRIMS; the port's goes on, ``require_mode``.)"""
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
    """The scene's kernel mode. Past MAX_STREAM_KERNEL_PRIMS primitives with
    a BVH, where the JAX Renderer leaves its kernels for the banded jnp
    engine (raytrace_tpu/renderer.py:917-972), the port stays in stream
    mode: K6-stream and K5 keep their tables in global memory, and their
    plain versions compute what that engine computes. Raises ValueError
    past MAX_STREAM_ROWS primitives, where the stream node table's float32
    integers are no longer exact."""
    mode = _kernel_mode(scene)
    if mode == "stream" and scene.prim_count > MAX_STREAM_ROWS:
        raise ValueError(
            f"scene has {scene.prim_count} primitives: the stream kernels' "
            f"node table holds leaf offsets as float32 integers, exact up "
            f"to {MAX_STREAM_ROWS} (csrc/trace_stream.cu)")
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
    """Does K7 take these tables (``pack_tables``) into shared memory
    (within ``LOOP_SMEM_BYTES``; else it reads them in place)?"""
    return 4 * sum(tabs[k].numel() for k in ORDER) <= LOOP_SMEM_BYTES


def trace_smem_bytes(scene) -> int:
    """Bytes of dynamic shared memory a block of the scene's trace launch
    takes: K1 its tables, K7 its tables within LOOP_SMEM_BYTES, K3+K4 its
    walk table within BVH_SMEM_BYTES; 0 where the kernel reads them in
    place (K5 always)."""
    mode = require_mode(scene)
    if mode == "stream":
        return 0
    flat, _, extra = trace_tables(scene, mode)
    if mode == "bvh":
        return 4 * extra.numel() if walk_table_in_smem(extra) else 0
    return 4 * flat.numel() if mode == "unroll" or extra else 0


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


def pack_walk_table(scene, tabs=None) -> torch.Tensor:
    """K3+K4's walk table, flat float32: what its three walks read.

    First the tree the walks take: the 4-wide table (W,36) where
    ``bvh.wide_walk`` says so, else the binary node table (N,9) of
    ``pack_bvh_tables``, padded to a multiple of 4 floats. Then one row of
    WALK_ROW floats per leaf slot, in slot order (the tree's, so the
    first-minimum tie order is unchanged), with ``prim_index`` resolved:
    v0, e1, e2 of a hit triangle, or a sphere's center and radius then
    zeros; the tag (0 sphere, 1 triangle, 2 cube face, which the walks
    skip: boxes are a cube's hit form); the id (the row of ``tabs``'
    sphere or triangle table, which hold the hit's attributes); 0. The
    floats are those of ``pack_tables`` (``tabs``, packed here when not
    given), so the walks compute what they compute over the scene tables.
    Rows are 48 bytes, so every row is 16-byte aligned."""
    accel = scene.accel
    tabs = pack_tables(scene) if tabs is None else tabs
    sph, tri = tabs["sph"], tabs["tri"]
    dev = sph.device
    ns, nt = sph.shape[0], tri.shape[0]
    pid = accel.prim_index.to(torch.int64)
    is_s = pid < ns
    ti = pid - ns
    is_t = ~is_s & (ti < nt)
    data = torch.zeros((pid.shape[0], 9), dtype=torch.float32, device=dev)
    if ns:
        data[is_s, 0:4] = sph[pid[is_s], 0:4]
    if nt:
        data[is_t] = tri[ti[is_t], 0:9]
    tag = torch.where(is_s, 0.0, torch.where(is_t, 1.0, 2.0))
    ids = torch.where(is_s, pid, ti).to(torch.float32)
    rows = torch.cat([data, tag[:, None], ids[:, None],
                      torch.zeros_like(tag)[:, None]], 1)
    if bvh_mod.wide_walk(accel):
        nodes = accel.wide4.reshape(-1)
    else:
        nodes = pack_bvh_tables(accel)[0].reshape(-1)
        nodes = torch.cat([nodes, nodes.new_zeros((-nodes.numel()) % 4)])
    return torch.cat([nodes.to(torch.float32), rows.reshape(-1)])


def walk_table_in_smem(walk: torch.Tensor) -> bool:
    """Does K3+K4 take this walk table into shared memory (else it reads
    it in place)?"""
    return 4 * walk.numel() <= BVH_SMEM_BYTES


def walk_table_plain(scene, origin, direction, t_min, t_max, *,
                     any_hit: bool = False, walk=None):
    """The walks of K3+K4 over its walk table alone (the table's plain
    version; the plain engine walks the scene tables, ``trace.trace``):
    the closest hit, (t, primitive id) as ``bvh.traverse_closest``, or
    with ``any_hit`` the hard-shadow verdicts of ``bvh.traverse_any``, in
    the order of the table's tree (4-wide or binary)."""
    accel = scene.accel
    walk = pack_walk_table(scene) if walk is None else walk
    wide = bvh_mod.wide_walk(accel)
    n_wide = accel.wide4.shape[0] if wide else 0
    n_tree = 36 * n_wide if wide else 9 * accel.n_nodes
    tree = bvh_mod.walk_view(walk[:n_tree], accel.n_nodes, n_wide,
                             accel.leaf_size)
    leaves = bvh_mod.WalkLeaves(walk[n_tree + (-n_tree) % 4:].reshape(
                                    -1, WALK_ROW),
                                accel.leaf_size,
                                scene.geometry.sph_center.shape[0])
    if any_hit:
        fn = bvh_mod.traverse_any_wide if wide else bvh_mod.traverse_any
    else:
        fn = (bvh_mod.traverse_closest_wide if wide
              else bvh_mod.traverse_closest)
    return fn(tree, None, origin, direction, t_min, t_max, leaves=leaves)


def _mask_camera(scene, width, height, cfg, go_camera) -> torch.Tensor:
    """(18,) float32 camera row of the mask kernels: [origin.xyz, A.xyz,
    B.xyz, C.xyz, k, kp, ll, Le, c_lo, c_hi] (``csrc/pixel_mask.cu``).

    k is the jitter cone (``_cone_half_sin``). With thin-lens depth of
    field, Le = lens radius * sqrt(|up|^2 + 1) bounds the lens offset
    rd.x * up + rd.y * unit(LookAt x Up) (``camera.thin_lens_perturb``,
    with the scene's up as given, not normalised; sqrt(2) * lens radius
    for a unit up, the JAX kernel's); planes take the JAX kernel's
    direction-cone bound kp = k + Le/(F - Le) and origin slack
    ll = Le*(1 + kp) (pixel_mask_pallas :2741-2762); the bounding-sphere
    test takes the corrected slack, over c_lo = 1/(F(1+k) + Le) and
    c_hi = 1/max(F(1-k) - Le, eps) (see csrc/pixel_mask.cu). Without it
    kp = k and the other four are 0."""
    cam4 = _affine_camera(scene, go_camera)
    k = _cone_half_sin(cam4, width, height)
    zero = k * 0.0
    if cfg.depth_of_field:
        L = np.float32(cfg.dof_lens_radius)
        F = np.float32(max(cfg.dof_focus_distance, 1e-6))
        up = scene.camera.up.to(torch.float32)
        le = float(L) * _sqrt(up[0] * up[0] + up[1] * up[1] + up[2] * up[2]
                              + 1.0)
        kp = k + le / torch.clamp(float(F) - le, min=1e-6)
        ll = le * (1.0 + kp)
        c_lo = 1.0 / (float(F) * (1.0 + k) + le)
        c_hi = 1.0 / torch.clamp(float(F) * (1.0 - k) - le, min=1e-6)
    else:
        kp, ll, le, c_lo, c_hi = k, zero, zero, zero, zero
    return torch.cat([cam4.reshape(-1)] + [
        t.reshape(1) for t in (k, kp, ll, le, c_lo, c_hi)]).to(torch.float32)


def _mask_tree(scene, cam, cfg):
    """K6's tables: (nodes (N,9), prim_index (P,)), every node slab grown
    by the jitter cone at its farthest corner, k * |origin - corner| +
    eps, plus the fp slack 1e-3 * extent + 1e-3 (the bvh branch of
    pixel_mask_pallas, :2777). With depth of field the JAX kernel's
    per-node pad over |d_j| in [1, dmax] (:2774-2791): k*s_hi +
    Le*maxfac + eps, s_hi = d_far + Le."""
    eps = 1e-3
    nodes, pidx = pack_bvh_tables(scene.accel)
    nmin, nmax = nodes[:, 0:3], nodes[:, 3:6]
    o, k = cam[0:3], cam[12]
    far = torch.maximum(torch.abs(nmin - o), torch.abs(nmax - o))
    d_far = _sqrt(far[:, 0] * far[:, 0] + far[:, 1] * far[:, 1]
                  + far[:, 2] * far[:, 2])
    if cfg.depth_of_field:
        le = cam[15]
        near = torch.clamp(torch.maximum(nmin - o, o - nmax), min=0.0)
        d_near = _sqrt(near[:, 0] * near[:, 0] + near[:, 1] * near[:, 1]
                       + near[:, 2] * near[:, 2])
        norm = lambda v: _sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
        dmax = norm(cam[3:6]) + norm(cam[6:9]) + norm(cam[9:12])
        F = float(np.float32(max(cfg.dof_focus_distance, 1e-6)))
        s_lo = torch.clamp(d_near - le, min=0.0)
        s_hi = d_far + le
        maxfac = torch.maximum(
            torch.abs(1.0 - s_lo / (F * dmax + le)),
            torch.abs(1.0 - s_hi / torch.clamp(F - le, min=1e-6)))
        padn = (k * s_hi + le * maxfac + eps)[:, None]
    else:
        padn = (k * d_far + eps)[:, None]
    fp = 1e-3 * (nmax - nmin) + 1e-3
    return (torch.cat([nmin - padn - fp, nmax + padn + fp, nodes[:, 6:]],
                      1), pidx)


def _node_rows(nodes) -> torch.Tensor:
    """(N,9) [min.xyz, max.xyz, skip, first, count] -> the mask table's
    (N,12) node rows [min.xyz, skip, max.xyz, first, count, 0, 0, 0]."""
    return torch.cat([nodes[:, 0:3], nodes[:, 6:7], nodes[:, 3:6],
                      nodes[:, 7:9], nodes.new_zeros((nodes.shape[0], 3))],
                     1)


def _leaf_rows(bs, cam, dof: bool) -> torch.Tensor:
    """(P,8) leaf rows of the mask table from bounding spheres bs (P,4) in
    slot order: [oc.xyz, |oc|^2, dist, r, R, R*R], the terms of
    ``_bs_hit`` that do not depend on the pixel (R its finished radius);
    with depth of field [..., dist, r, r + (dist + r)*k, 0], since the
    thin-lens slack is the pixel's."""
    oc = bs[:, :3] - cam[0:3]
    ocx, ocy, ocz = oc[:, 0], oc[:, 1], oc[:, 2]
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    r = bs[:, 3]
    dist = _sqrt(oc2)
    base = r + (dist + r) * cam[12]
    if dof:
        a, b = base, torch.zeros_like(base)
    else:
        a = base + 1e-3       # _bs_hit's R at dofl = 0
        b = a * a
    return torch.stack([ocx, ocy, ocz, oc2, dist, r, a, b], 1)


def mask_table_plain(scene, cam, cfg) -> torch.Tensor:
    """The mask table of K6 (bvh mode) or K6-stream (stream mode), flat
    float32: the plain version of their pre-pass and of the walk's
    prologue (``csrc/pixel_mask.cu``: ``mask_row``) for the camera row
    ``cam`` (``_mask_camera``). First a node row of MASK_NODE floats a tree
    node
    (``_node_rows`` of ``_mask_tree``'s grown slabs); then, in bvh mode, a
    leaf row of MASK_LEAF floats a leaf slot, in slot order
    (``_leaf_rows`` of ``_bsphere_table``'s row of prim_index[slot])."""
    mode = require_mode(scene)
    nodes, pidx = _mask_tree(scene, cam, cfg)
    rows = _node_rows(nodes).reshape(-1)
    if mode == "stream":
        return rows
    bs = _bsphere_table(scene)[pidx.to(torch.int64)]
    return torch.cat([rows, _leaf_rows(bs, cam,
                                       cfg.depth_of_field).reshape(-1)])


def mask_table_in_smem(n_floats: int) -> bool:
    """Does the K6 or K6-stream walk build a mask table of this many
    floats in shared memory, after the camera row (else the pre-pass
    writes it and the walk reads it in place)?"""
    return 4 * (MASK_CAM + n_floats) <= MASK_SMEM_BYTES


def k2_table_plain(scene, cam, cfg) -> torch.Tensor:
    """K2's table, flat float32: a leaf row of MASK_LEAF floats a
    primitive, in primitive order (``_leaf_rows`` of ``_bsphere_table``:
    the spheres, then every triangle's bounding sphere) for the camera row
    ``cam``: the plain version of the rows each K2 block builds in its
    prologue (``csrc/pixel_mask.cu``: ``mask_leaf_row`` through an
    identity prim_index)."""
    return _leaf_rows(_bsphere_table(scene), cam,
                      cfg.depth_of_field).reshape(-1)


def k2_chunk_rows() -> int:
    """Leaf rows of a K2 chunk: as many as fit MASK_SMEM_BYTES after the
    camera row. A table of more rows is built and tested a chunk at a
    time."""
    return max(1, (MASK_SMEM_BYTES // 4 - MASK_CAM) // MASK_LEAF)


# ------------------------------------------------ K2, K6, K6-stream ----

def _bs_hit(o, dx, dy, dz, inv_a, sqa, inv_sq, cam, bs):
    """The cone-inflated bounding-sphere test of ``csrc/pixel_mask.cu``
    (``bs_hit``), with its thin-lens slack: rows bs (..., 4) against center
    rays whose direction components (and inv_a = 1/|d|^2, sqa = |d|,
    inv_sq = 1/|d|) broadcast against them."""
    k, ll, le, c_lo, c_hi = cam[12], cam[14], cam[15], cam[16], cam[17]
    oc = bs[..., :3] - o
    ocx, ocy, ocz = oc[..., 0], oc[..., 1], oc[..., 2]
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    g = ocx * dx + ocy * dy + ocz * dz
    r = bs[..., 3]
    dist = _sqrt(oc2)
    n_lo = dist - r - le
    n_hi = dist + r + le
    x_lo = n_lo * inv_sq * torch.where(n_lo >= 0.0, c_lo, c_hi)
    x_hi = n_hi * inv_sq * c_hi
    dofl = le * (1.0 + k) * torch.maximum(torch.abs(1.0 - x_lo),
                                          torch.abs(1.0 - x_hi))
    R = r + (dist + r) * k + dofl + 1e-3
    return (oc2 - g * g * inv_a <= R * R) & (g >= -(R + ll) * sqa)


def _leaf_hit(rows, dx, dy, dz, inv_a, sqa, inv_sq, cam, dof: bool):
    """``_bs_hit`` over leaf rows of the mask table (..., MASK_LEAF)
    (``csrc/pixel_mask.cu``: ``leaf_hit``): the same bits."""
    g = rows[..., 0] * dx + rows[..., 1] * dy + rows[..., 2] * dz
    R, R2 = rows[..., 6], rows[..., 7]
    if dof:
        k, le, c_lo, c_hi = cam[12], cam[15], cam[16], cam[17]
        dist, r = rows[..., 4], rows[..., 5]
        n_lo = dist - r - le
        n_hi = dist + r + le
        x_lo = n_lo * inv_sq * torch.where(n_lo >= 0.0, c_lo, c_hi)
        x_hi = n_hi * inv_sq * c_hi
        dofl = le * (1.0 + k) * torch.maximum(torch.abs(1.0 - x_lo),
                                              torch.abs(1.0 - x_hi))
        R = R + dofl + 1e-3
        R2 = R * R
    return ((rows[..., 3] - g * g * inv_a <= R2)
            & (g >= -(R + cam[14]) * sqa))


def _mask_walk(o, d, nodes, leaf_size, leaf_hits, work):
    """(P,) bool: the skip walk of every pixel's center ray (origin o,
    directions d (P,3)) over node rows (N,12) in the mask table's layout
    (near clamped at 0); a boxed leaf calls ``leaf_hits(slots (A,L),
    pixels (A,))`` for its slots [first, first + leaf_size) (clamped;
    those past count are dropped) or, with ``leaf_hits`` None (K6-stream,
    the node-only branch), marks the pixel at once; a pixel stops at its
    first hit. ``work`` (a list of two ints, or None) gets the node slab
    tests and the leaf tests added to it."""
    P, n = d.shape[0], nodes.shape[0]
    iv = 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-30), d)
    lo, hi = nodes[:, 0:3], nodes[:, 4:7]
    skip, first, cnt = (nodes[:, c].to(torch.int64) for c in (3, 7, 8))
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
        if leaf_hits is None:
            h = boxed & leaf
        else:
            at = (boxed & leaf).nonzero()[:, 0]
            h = torch.zeros_like(boxed)
            if at.numel():
                c = cur[at]
                slot = first[c][:, None] + slots
                valid = slots < cnt[c][:, None]
                if work is not None:
                    work[1] += int(valid.sum())
                h[at] = torch.any(leaf_hits(slot, act[at]) & valid, dim=-1)
        hit[act[h]] = True
        nxt = torch.where(boxed & ~leaf, cur + 1, skip[cur])
        nxt = torch.where(h, n, nxt)
        cursor[act] = nxt
        act = act[nxt < n]
    return hit


def _center_rays(cam, width, height, device):
    """The pixels' center-ray directions d (P,3) of the camera row and
    inv_a = 1/|d|^2, sqa = |d|, inv_sq = 1/|d| (P,1), as
    ``csrc/pixel_mask.cu:center_ray`` computes them."""
    inv_w = float(np.float32(1.0 / width))
    inv_h = float(np.float32(1.0 / height))
    pix = torch.arange(width * height, device=device)
    u = ((pix % width).to(torch.float32) + 0.5) * inv_w
    v = ((pix // width).to(torch.float32) + 0.5) * inv_h
    d = cam[3:6] + u[:, None] * cam[6:9] + v[:, None] * cam[9:12]  # (P,3)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    a = dx * dx + dy * dy + dz * dz
    sqa = _sqrt(a)
    return d, 1.0 / a, sqa, 1.0 / sqa


# (pixel, row) pairs a step of the plain K2 tests: the plain version goes
# over the pixels in steps, so that its intermediates stay small at any
# table size.
K2_PLAIN_PAIRS = 1 << 22


def _k2_hits(rows, d, inv_a, sqa, inv_sq, cam, dof: bool) -> torch.Tensor:
    """(P,) bool: K2's bounding-sphere tests of every pixel against every
    leaf row (rows (n, MASK_LEAF)), or-ed, in steps of pixels."""
    P, n = d.shape[0], rows.shape[0]
    hit = torch.zeros(P, dtype=torch.bool, device=d.device)
    step = max(1, K2_PLAIN_PAIRS // max(n, 1))
    for a in range(0, P if n else 0, step):
        sl = slice(a, a + step)
        dd = d[sl]
        hit[sl] = torch.any(_leaf_hit(rows[None], dd[:, 0:1], dd[:, 1:2],
                                      dd[:, 2:3], inv_a[sl], sqa[sl],
                                      inv_sq[sl], cam, dof), dim=-1)
    return hit


def k2_walk_plain(rows, d, inv_a, sqa, inv_sq, cam, dof: bool, hit=None,
                  work=None) -> torch.Tensor:
    """(P,) bool: K2's loop as the kernel runs it: each pixel not already
    in ``hit`` (the planes' bits) tests the leaf rows (n, MASK_LEAF) in
    order and stops at its first hit. ``work`` (a list, or None) gets the
    leaf tests added to its element 1. The bits equal ``_k2_hits``'."""
    hit = (torch.zeros(d.shape[0], dtype=torch.bool, device=d.device)
           if hit is None else hit.clone())
    act = (~hit).nonzero()[:, 0]
    for j in range(rows.shape[0]):
        if not act.numel():
            break
        if work is not None:
            work[1] += act.numel()
        dd = d[act]
        h = _leaf_hit(rows[j], dd[:, 0], dd[:, 1], dd[:, 2], inv_a[act, 0],
                      sqa[act, 0], inv_sq[act, 0], cam, dof)
        hit[act[h]] = True
        act = act[~h]
    return hit


def _planes_hit(point, normal, o, dx, dy, dz, cam) -> torch.Tensor:
    """(P,) bool: the planes' interval test (``csrc/pixel_mask.cu``:
    ``planes_hit``) of center rays dx, dy, dz (P,1) from o, every plane
    (point, normal (Np,3))."""
    kp, ll, eps = cam[13], cam[14], 1e-3
    n = normal[None]
    denom = dx * n[..., 0] + dy * n[..., 1] + dz * n[..., 2]
    pd = point[None] - o
    num = (pd[..., 0] * n[..., 0] + pd[..., 1] * n[..., 1]
           + pd[..., 2] * n[..., 2])
    return torch.any((torch.abs(denom) <= kp + eps) | (num * denom > 0.0)
                     | (torch.abs(num) <= ll + eps), dim=-1)


def mask_walk_plain(scene, cam, table, *, width: int, height: int, cfg,
                    work=None) -> torch.Tensor:
    """(H*W,) bool: the walk of K6 (bvh mode) or K6-stream (stream mode)
    over a mask table (``mask_table_plain``), planes left out."""
    n = scene.accel.n_nodes
    nodes = table[:MASK_NODE * n].reshape(n, MASK_NODE)
    d, inv_a, sqa, inv_sq = _center_rays(cam, width, height, scene.device)
    leaf_hits = None
    if require_mode(scene) == "bvh":
        leaves = table[MASK_NODE * n:].reshape(-1, MASK_LEAF)
        last = leaves.shape[0] - 1

        def leaf_hits(slot, px):
            dd = d[px]
            return _leaf_hit(leaves[torch.clamp(slot, max=last)],
                             dd[:, 0:1], dd[:, 1:2], dd[:, 2:3], inv_a[px],
                             sqa[px], inv_sq[px], cam, cfg.depth_of_field)

    return _mask_walk(cam[0:3], d, nodes, scene.accel.leaf_size, leaf_hits,
                      work)


def pixel_mask_plain(scene, *, width: int, height: int, cfg,
                     go_camera: bool = True, work=None,
                     cam=None) -> torch.Tensor:
    """The plain version of K2 (unroll and loop modes), K6 (bvh mode) and
    K6-stream (stream mode): (H*W,) bool, the same float32 operations as
    ``csrc/pixel_mask.cu``, vectorised over pixels; K2 tests
    ``k2_table_plain``'s rows, K6 and K6-stream walk ``mask_table_plain``'s
    table. ``cam``: the camera row (18,) to use (the kernels' own,
    ``MaskLaunch.cam``), else ``_mask_camera``'s. ``work`` (a list of two
    ints, or None): bvh and stream modes, see _mask_walk; unroll and loop
    modes, element 1 gets K2's leaf tests (``k2_walk_plain``: the planes
    first, then the rows to the first hit)."""
    mode = require_mode(scene)
    if cam is None:
        cam = _mask_camera(scene, width, height, cfg, go_camera)
    g, dev = scene.geometry, scene.device
    o = cam[0:3]
    d, inv_a, sqa, inv_sq = _center_rays(cam, width, height, dev)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    hit = torch.zeros((width * height,), dtype=torch.bool, device=dev)
    if g.pl_point.shape[0]:
        hit |= _planes_hit(g.pl_point, g.pl_normal, o, dx, dy, dz, cam)
    if mode in ("bvh", "stream"):
        hit |= mask_walk_plain(scene, cam, mask_table_plain(scene, cam, cfg),
                               width=width, height=height, cfg=cfg,
                               work=work)
        return hit
    rows = k2_table_plain(scene, cam, cfg).reshape(-1, MASK_LEAF)
    if work is not None:
        return k2_walk_plain(rows, d, inv_a, sqa, inv_sq, cam,
                             cfg.depth_of_field, hit, work)
    return hit | _k2_hits(rows, d, inv_a, sqa, inv_sq, cam,
                          cfg.depth_of_field)


@dataclasses.dataclass
class MaskLaunch:
    """A prepared mask launch on the card (``prepare_pixel_mask``). Calling
    it runs the mask kernel (``walk``), after the pre-pass where it reads
    its table in place (``in_smem`` False and ``prepass`` set; in shared
    memory each block of the kernel builds the table itself).
    ``prepass()`` writes the mask table to ``table``. ``cam``: the camera
    row (18,) that the kernels build, written by its own one-thread
    launch (``rt_mask_camera``, counted under ``mask_camera``) each time
    it is read."""

    prepass: object    # the pre-pass launch, or None
    walk: object       # the mask kernel's launch
    table: object = None
    camera: object = None  # launches the camera row alone, returns it
    in_smem: bool = False

    @property
    def cam(self) -> torch.Tensor:
        return self.camera()

    def __call__(self) -> None:
        if self.prepass is not None and not self.in_smem:
            self.prepass()
        self.walk()


def _f32(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: dtype {t.dtype}, not float32")
    return t.contiguous()


def _i32(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype != torch.int32:
        raise ValueError(f"{what}: dtype {t.dtype}, not int32")
    return t.contiguous()


def _camera_args(scene, cfg, go_camera):
    """The camera of a mask launch as the C launchers take it
    (``csrc/pixel_mask.cu``: RT_MASK_CAM_ARGS): the scene's position,
    look_at, up, fov and aspect_ratio tensors, go, dof, the float32 lens
    radius and focus distance (``_mask_camera``'s L and F)."""
    c = scene.camera
    dof = bool(cfg.depth_of_field)
    return (_f32(c.position, "camera.position"),
            _f32(c.look_at, "camera.look_at"), _f32(c.up, "camera.up"),
            _f32(c.fov, "camera.fov"),
            _f32(c.aspect_ratio, "camera.aspect_ratio"), int(go_camera),
            int(dof), float(np.float32(cfg.dof_lens_radius)) if dof else 0.0,
            float(np.float32(max(cfg.dof_focus_distance, 1e-6))))


def prepare_pixel_mask(scene, *, width: int, height: int, cfg,
                       go_camera: bool = True):
    """The mask kernel's inputs on the card: returns (out, launch).
    ``launch()`` (a ``MaskLaunch``) runs K2 (unroll and loop modes), K6
    (bvh mode) or K6-stream (stream mode) into ``out``, (H*W,) bool,
    counting the launch under the kernel's name (``MASKS``). Every mask
    block builds the camera row and its table from the scene's own
    tensors: the host only allocates the output (and K6's table, which
    the pre-pass fills past the budget). K6 and K6-stream build their mask
    table in each block's shared memory, or, past ``MASK_SMEM_BYTES``,
    read the table that the pre-pass (counted under ``mask_table``)
    writes, in place (counted under ``pixel_mask_ldg`` too); K2 builds its
    rows ``k2_chunk_rows()`` at a time (more than one chunk: counted
    under ``pixel_mask_chunked``)."""
    dev = scene.device
    if dev.type != "cuda":
        raise RuntimeError(f"pixel_mask kernel: device {dev} is not CUDA")
    mode = require_mode(scene)
    name = MASKS[mode]
    acc, g = scene.accel, scene.geometry
    out = torch.empty((width * height,), dtype=torch.bool, device=dev)
    lib = _build.library()
    inv_w = float(np.float32(1.0 / width))
    inv_h = float(np.float32(1.0 / height))
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda a: a.data_ptr() if isinstance(a, torch.Tensor) else a
    # the kernels' arguments; tensors stay referenced here until a launch
    # reads their pointers
    cam = _camera_args(scene, cfg, go_camera)
    head = (out, width, height, inv_w, inv_h) + cam
    planes = (_f32(g.pl_point, "pl_point"), _f32(g.pl_normal, "pl_normal"),
              g.pl_point.shape[0])
    ns, nt = g.sph_center.shape[0], g.tri_v0.shape[0]
    prims = (_f32(g.sph_center, "sph_center"),
             _f32(g.sph_radius, "sph_radius"), ns,
             _f32(g.tri_v0, "tri_v0"), _f32(g.tri_v1, "tri_v1"),
             _f32(g.tri_v2, "tri_v2"))
    table, prep, chunked = None, None, False
    if mode in ("bvh", "stream"):
        n_slots = acc.prim_index.shape[0] if mode == "bvh" else 0
        tree = (_f32(acc.node_min, "node_min"),
                _f32(acc.node_max, "node_max"),
                _i32(acc.node_skip, "node_skip"),
                _i32(acc.node_first, "node_first"),
                _i32(acc.node_count, "node_count"), acc.n_nodes,
                _i32(acc.prim_index, "prim_index"), n_slots)
        table = torch.empty((MASK_NODE * acc.n_nodes + MASK_LEAF * n_slots,),
                            dtype=torch.float32, device=dev)
        in_smem = mask_table_in_smem(table.numel())
        prep = (table, width, height) + cam + tree + prims
        args = head + (table, table.numel(), int(in_smem)) + planes + tree
    else:
        # no tree, an identity prim_index, a leaf row a primitive
        tree = (None,) * 5 + (0, None, ns + nt)
        chunk = k2_chunk_rows()
        in_smem = ns + nt <= chunk
        chunked = not in_smem
        args = head + (chunk,) + planes + tree
    args = args + prims
    entry = getattr(lib, "rt_" + name)

    def table_fn():
        _build.check(lib.rt_mask_table(*map(ptr, prep), stream()),
                     "mask_table")
        LAUNCHES["mask_table"] += 1

    def walk_fn():
        _build.check(entry(*map(ptr, args), stream()), name)
        LAUNCHES[name] += 1
        if table is not None and not in_smem:
            LAUNCHES["pixel_mask_ldg"] += 1
        if chunked:
            LAUNCHES["pixel_mask_chunked"] += 1
        if cfg.depth_of_field:
            LAUNCHES["mask_dof"] += 1

    def camera_fn():
        row = torch.empty((18,), dtype=torch.float32, device=dev)
        _build.check(lib.rt_mask_camera(row.data_ptr(), width, height,
                                        *map(ptr, cam), stream()),
                     "mask_camera")
        LAUNCHES["mask_camera"] += 1
        return row

    return out, MaskLaunch(table_fn if prep else None, walk_fn, table,
                           camera_fn, in_smem)


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
    ``csrc/bounce.cuh``, then in stream mode the node table and the 4-wide
    table when the walks take it (``bvh.wide_walk``; else n_wide is 0 and
    they walk the binary tree); the table sizes as ``bounce.cuh:Dims``;
    and ``extra``: in loop mode whether K7 takes the tables into shared
    memory (``loop_tables_in_smem``), in bvh mode K3+K4's walk table
    (``pack_walk_table``), in stream mode the stream table, which K5 reads
    in place).

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
        wide = bvh_mod.wide_walk(accel)   # K3-wide: the 4-wide table
        if mode == "bvh":
            extra = pack_walk_table(scene, tabs)
        else:
            parts.append(pack_bvh_tables(accel)[0].reshape(-1))
            if wide:
                parts.append(accel.wide4.reshape(-1))
        dims += [accel.n_nodes, accel.leaf_size,
                 accel.wide4.shape[0] if wide else 0]
    else:
        dims += [0, 0, 0]
    if mode == "loop":
        extra = loop_tables_in_smem(tabs)
    return torch.cat(parts).contiguous(), dims, extra


def prepare_trace(scene, origin, direction, pix_id, samp_id, cfg,
                  *, start_bounce: int = 0, end_bounce=None,
                  init_throughput=None, init_alive=None,
                  return_state: bool = False,
                  counters: torch.Tensor | None = None,
                  soft_guard: bool = True):
    """The trace kernel's inputs on the card: returns (out, launch).
    ``launch()`` runs K1 (unroll mode), K3+K4 (bvh mode), K5 (stream mode)
    or K7 (loop mode) into ``out`` and counts the launch under the
    kernel's name (``KERNELS``), under ``trace_state`` too when it
    resumes or returns lane state (K1-state), and under ``trace_wide`` when
    its walks take the 4-wide table (K3-wide).

    ``out`` is (B,3) float32 radiance, or with ``return_state`` the pair
    (radiance, state) of ``trace.trace``. ``start_bounce``, ``end_bounce``,
    ``init_throughput`` and ``init_alive`` are those of ``trace.trace``.

    ``cfg``'s fast_mc settings go to the kernel as ``rr_start`` (-1: off)
    and ``tp_eps`` (``csrc/bounce.cuh:Run``). ``soft_guard`` (K1 and K7)
    runs K1-guard, as every main-path launch does; False runs the
    unguarded soft-shadow loop, which gives the same result (for
    comparisons on the card; the JAX package's RT_SOFT_PRIM=0, and its
    loop mode). K3+K4 reads its walk table from shared memory within
    ``BVH_SMEM_BYTES``, else in place (``trace_bvh_ldg``); K7 its tables
    within ``LOOP_SMEM_BYTES``, else in place (``trace_loop_ldg``).

    ``counters`` (for operation counts; off on the main path) receives
    each lane's work. Unroll and loop modes, (B, COUNTERS) int32:
    closest-hit rays, hard and soft shadow rays (the soft ones a lane
    asked for), occlusion tests of spheres+planes and of triangles+boxes,
    and K1-guard's guard evaluations, flagged occluders and undrawn soft
    rays (0 unguarded). Bvh and stream modes, (B,
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
    guard = mode in ("unroll", "loop") and bool(soft_guard)
    rr_start = (-1 if cfg.russian_roulette_start is None
                else int(cfg.russian_roulette_start))
    rad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if counters is not None and (
            tuple(counters.shape) != (n, n_counters)
            or counters.dtype != torch.int32 or counters.device != dev
            or not counters.is_contiguous()):
        raise ValueError(f"counters must be a contiguous (B,{n_counters}) "
                         "int32 tensor on the scene's device")
    entry = getattr(_build.library(), "rt_" + kernel)
    dims_c = (ctypes.c_int * len(dims))(*dims)
    ldg = False
    # the lane counter of the persistent kernels (their launchers zero it
    # on the stream before each launch)
    nxt = (None if mode == "stream"
           else torch.zeros((1,), dtype=torch.int32, device=dev))
    if mode == "loop":
        ldg = not extra
        extra_args = (int(extra), nxt)  # in shared memory, the counter
    elif mode == "stream":
        extra_args = (extra,)  # the stream table: K5 reads it in place
    elif mode == "bvh":
        ldg = not walk_table_in_smem(extra)
        # the walk table, its length, in shared memory, the lane counter
        extra_args = (extra, extra.numel(), int(not ldg), nxt)
    else:
        extra_args = (nxt,)

    def launch():
        err = entry(
            o.data_ptr(), d.data_ptr(), pix.data_ptr(), samp.data_ptr(),
            ptr(tp), ptr(al), rad.data_ptr(), ptr(state), ptr(counters), n,
            flat.data_ptr(), dims_c, *(ptr(a) if isinstance(a, torch.Tensor)
                                       else a for a in extra_args),
            start_bounce, end,
            cfg.shadow_samples, int(cfg.soft_shadows),
            int(cfg.recursive_reflections), cfg.seed & 0xFFFFFFFF,
            rr_start, float(cfg.throughput_epsilon), int(guard),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, kernel)
        LAUNCHES[kernel] += 1
        if ldg:
            LAUNCHES[kernel + "_ldg"] += 1
        if stateful:
            LAUNCHES["trace_state"] += 1
        if wide:
            LAUNCHES["trace_wide"] += 1
        if guard:
            LAUNCHES["trace_guard"] += 1

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


# ------------------------------------------------ K1-guard, plain ----

_CONE, _EPS_T, _EPS_CC = 0.102, np.float32(1e-4), 1e-4
_GUARD_T = float(np.float32(1e-3) - _EPS_T)  # t_min - eps_t in float32


def _sphere_guard(ocx, ocy, ocz, cc, r, ld, dist):
    """``csrc/brute_force.cuh:sphere_guard``: (B,N) bool from the
    direction-free terms of bounding spheres (oc = p - center,
    cc = |oc|^2 - r^2) against the unit light direction ld (B,3) and
    dist (B,)."""
    ldx, ldy, ldz = (ld[:, i:i + 1] for i in range(3))
    dist = dist[:, None]
    oc2 = cc + r * r
    g = ocx * ldx + ocy * ldy + ocz * ldz
    u_lo = g - _CONE * _sqrt(oc2)
    slack = _EPS_CC + 1e-6 * oc2
    disc_lo = u_lo * u_lo - cc
    root_max = -u_lo + _sqrt(torch.clamp(disc_lo, min=0.0))
    has = (cc <= slack) | ((u_lo <= 0.0) & (disc_lo >= -slack))
    R = r + _CONE * dist + _EPS_CC
    return has & (root_max >= _GUARD_T) & (-g <= dist + R)


def _bounding_guard(center_off, br, ld, dist):
    """The guard of bounding spheres given p - center as (B,N) components
    and radii br (N,)."""
    ocx, ocy, ocz = center_off
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    return _sphere_guard(ocx, ocy, ocz, oc2 - br * br, br, ld, dist)


def soft_guard_mask(tables, p, ld, dist, need) -> torch.Tensor:
    """K1-guard's plain version: (B, occluders) bool in the kernel's order
    [spheres, hit triangles, boxes, planes] - can any ray of the light's
    soft-shadow cone from p (B,3) around the unit direction ld (B,3) hit
    this occluder in [t_min, dist (B,)]? False where ``need`` (B,) bool is
    False. ``tables``: ``pack_tables``'s dict, or ``occluder_tables``'s
    (the columns read are the leading ones). The float32 operations are
    those of ``csrc/brute_force.cuh``."""
    px, py, pz = (p[:, i:i + 1] for i in range(3))
    parts = []
    sph = tables["sph"]
    if sph.shape[0]:
        ocx, ocy, ocz = px - sph[:, 0], py - sph[:, 1], pz - sph[:, 2]
        r = sph[:, 3]
        cc = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r
        parts.append(_sphere_guard(ocx, ocy, ocz, cc, r, ld, dist))
    tri = tables["tri"]
    if tri.shape[0]:
        third = float(np.float32(1.0 / 3.0))
        e1, e2 = tri[:, 3:6], tri[:, 6:9]
        m = (e1 + e2) * third
        sq = lambda v: v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]
        br = _sqrt(torch.maximum(sq(m), torch.maximum(sq(e1 - m),
                                                      sq(e2 - m))))
        off = tuple((pc - tri[:, i]) - m[:, i]
                    for i, pc in enumerate((px, py, pz)))
        parts.append(_bounding_guard(off, br, ld, dist))
    box = tables["box"]
    if box.shape[0]:
        e = (box[:, 3:6] - box[:, 0:3]) * 0.5
        br = _sqrt(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2])
        off = tuple(pc - (box[:, i] + box[:, 3 + i]) * 0.5
                    for i, pc in enumerate((px, py, pz)))
        parts.append(_bounding_guard(off, br, ld, dist))
    pln = tables["pln"]
    if pln.shape[0]:
        num = ((pln[:, 0] - px) * pln[:, 3] + (pln[:, 1] - py) * pln[:, 4]
               + (pln[:, 2] - pz) * pln[:, 5])
        parts.append(torch.abs(num) <= dist[:, None] + _EPS_CC)
    if not parts:
        return torch.zeros((p.shape[0], 0), dtype=torch.bool,
                           device=p.device)
    return torch.cat(parts, 1) & need[:, None]


def occluder_tables(geom) -> dict:
    """The occluders of the brute-force soft-shadow loop as ``pack_tables``
    lays them out (leading columns): sph [center, r], tri [v0, e1, e2]
    (hit triangles), pln [point, normal], box [min, max]."""
    nt = geom.n_hit_tris
    v0 = geom.tri_v0[:nt]
    return dict(
        sph=torch.cat([geom.sph_center, geom.sph_radius[:, None]], 1),
        tri=torch.cat([v0, geom.tri_v1[:nt] - v0, geom.tri_v2[:nt] - v0], 1),
        pln=torch.cat([geom.pl_point, geom.pl_normal], 1),
        box=torch.cat([geom.box_min, geom.box_max], 1))


def shadow_factor_guarded(geom, point, light_dist, light_dir, pix_id,
                          samp_id, bounce, light_index, *, soft_shadows=True,
                          shadow_samples=16, seed=0, accel=None):
    """``shade.shadow_factor`` with K1-guard: each soft ray tested only
    against the occluders that ``soft_guard_mask`` flags (1 where nothing
    is flagged): the plain version of the guarded shadow factor of K1 and
    K7, equal to the unguarded one bit for bit, for any occluder count.
    ``accel`` must be None (K1-guard is the brute-force soft loop's, in
    unroll and loop modes)."""
    if accel is not None:
        raise ValueError("K1-guard is the brute-force (unroll and loop) "
                         "soft loop")
    need = torch.ones_like(light_dist, dtype=torch.bool)
    can = soft_guard_mask(occluder_tables(geom), point, light_dir,
                          light_dist, need) if soft_shadows else None
    return _shadow_factor(geom, point, light_dist, light_dir, pix_id,
                          samp_id, bounce, light_index,
                          soft_shadows=soft_shadows,
                          shadow_samples=shadow_samples, seed=seed,
                          occluders=can)
