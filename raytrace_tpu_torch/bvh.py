"""Scene BVH: the median-split tree and the plain skip-pointer walks.

Port of the binary part of ``raytrace_tpu/bvh.py``. The tree is built on
the host in numpy (longest-axis median split, stable argsort, the
topology of the JAX package's tree) and flattened in DFS order with skip
pointers: a walk either descends to the next node (box hit) or jumps past
the subtree (miss), so one integer cursor per lane is the whole traversal
state and no stack is needed.

``traverse_closest`` and ``traverse_any`` walk the tree for a batch of
lanes at once (every live lane advances its own cursor each step). They
are the plain versions of the BVH kernels K3 and K4 and give the JAX
package's ``traverse_closest``/``traverse_any`` results: the same node
order, the same slab and primitive arithmetic, and the same strict
``t < t_best`` acceptance, so equal-``t`` ties resolve the same way. A
tree that carries the stream table (``FlatBVH.stream_tab``, stream mode)
is walked over its unified leaf rows, dispatching on each row's tag: the
plain version of K5, bit-equal to the walk over the scene tables.

``widen4`` collapses the tree into the 4-wide layout that the kernels'
closest-hit, hard-shadow and soft-shadow walks take by default
(``wide_walk``, K3-wide), and ``traverse_closest_wide`` is its plain
closest-hit walk: a per-lane stack in the JAX kernel's order, so it
differs from the binary walk only in which of two hits at exactly equal
``t`` wins. (The shadow walks' verdicts do not depend on the order: their
plain versions stay ``traverse_any``; ``traverse_any_wide`` takes the
4-wide order, for the walk table below.)

Every walk takes its leaf reads from the tree's own tables unless it is
given ``leaves``: ``WalkLeaves`` reads the rows of K3+K4's walk table
(``megakernel.pack_walk_table``), and ``walk_view`` gives the tree that
such a table holds, so the walks run over the table alone (its plain
version, ``megakernel.walk_table_plain``).

The tree build takes the longest-axis median split (the native C++ build
of ``native.py`` when it loaded, else numpy: the same tree) or, with
``method="sah"``, the binned surface-area heuristic, in numpy as in the
JAX package. An SAH tree can be far deeper than a median one;
``wide_walk`` sends a tree whose 4-wide stack would overflow the
kernels' to the binary walk.

The rest of the JAX module is here too: ``closest_hit_bvh`` (a batched
closest-hit walk over a sphere tree, plain PyTorch on the device of its
inputs), its per-lane ``sphere_hit_t`` and ``tri_hit_t``, and the host
structures ``Octree`` and ``KDTree`` with their per-ray Python queries,
which stay on the host by design (numpy, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .ops import intersect

BVH_THRESHOLD = 64       # from_dict builds a tree from this many prims
LEAF_SIZE_DEFAULT = 16   # primitives per leaf at most
_BIG = np.float32(3.0e38)  # the corners of an empty 4-wide slot
WIDE_STACK = 64          # a lane's stack in the kernels' 4-wide walk
                         # (csrc/bvh_walk.cuh kWideStack)
# The JAX kernel takes the 4-wide walk in stream mode only while its
# scalar memory holds the binary nodes, the 4-wide table and one leaf of
# 128-float rows within this many bytes (megakernel.py:3113-3118); the
# port keeps the same choice so that it walks in the reference's order.
WIDE_STREAM_BUDGET = 700_000


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """DFS-ordered nodes with skip pointers; leaves index a permutation of
    the primitives. A primitive id below the sphere count is a sphere,
    else id - n_spheres indexes the triangle table (cube faces included,
    which the walks mask out: their boxes are the hit form)."""

    node_min: torch.Tensor    # (N,3) float32 box lower corner
    node_max: torch.Tensor    # (N,3) float32 box upper corner
    node_skip: torch.Tensor   # (N,) int32 node to resume at on a miss
    node_first: torch.Tensor  # (N,) int32 first prim slot (leaves), else -1
    node_count: torch.Tensor  # (N,) int32 prims in a leaf, 0 for inner
    prim_index: torch.Tensor  # (P,) int32 permutation of primitive ids
    leaf_size: int = 4        # most primitives in any leaf
    # Stream mode only: the unified primitive rows in leaf order
    # (megakernel.pack_stream_table), packed once when the scene is built.
    stream_tab: Optional[torch.Tensor] = None
    # The 4-wide view (widen4), attached by build_scene_bvh: (W,36)
    # float32, per wide node 4 slots of [min.xyz, max.xyz, child, first,
    # count], and the most entries a walk's stack holds.
    wide4: Optional[torch.Tensor] = None
    wide_stack: int = 0

    @property
    def n_nodes(self) -> int:
        return int(self.node_min.shape[0])

    def to(self, device) -> "FlatBVH":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _sah_partition(lo, hi, idx, n_bins=16):
    """Binned surface-area-heuristic split -> (left ids, right ids).

    Centroids are binned on each axis and the (axis, bin boundary) of
    least N_L * A_L + N_R * A_R is taken; degenerate centroids fall back
    to the longest-axis median. Only inner splits are chosen: a node of
    at most leaf_size primitives stays a leaf (the caller's rule)."""
    centers = (lo[idx] + hi[idx]) * 0.5
    cmin = centers.min(axis=0)
    ext = centers.max(axis=0) - cmin

    def half_area(bmin, bmax):
        d = np.maximum(bmax - bmin, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
            + d[..., 2] * d[..., 0]

    best = None  # (cost, axis, left mask)
    for axis in range(3):
        if ext[axis] <= 0.0:
            continue
        b = np.minimum(((centers[:, axis] - cmin[axis])
                        * (n_bins / ext[axis])).astype(np.int64),
                       n_bins - 1)
        counts = np.bincount(b, minlength=n_bins)
        bin_lo = np.full((n_bins, 3), np.inf, np.float32)
        bin_hi = np.full((n_bins, 3), -np.inf, np.float32)
        np.minimum.at(bin_lo, b, lo[idx])
        np.maximum.at(bin_hi, b, hi[idx])
        lo_l = np.minimum.accumulate(bin_lo, axis=0)
        hi_l = np.maximum.accumulate(bin_hi, axis=0)
        lo_r = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
        hi_r = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
        n_l = np.cumsum(counts)[:-1]
        n_r = idx.size - n_l
        cost = np.where(
            (n_l > 0) & (n_r > 0),
            n_l * half_area(lo_l[:-1], hi_l[:-1])
            + n_r * half_area(lo_r[1:], hi_r[1:]),
            np.inf)
        k = int(np.argmin(cost))
        if np.isfinite(cost[k]) and (best is None or cost[k] < best[0]):
            best = (float(cost[k]), axis, b <= k)
    if best is None:
        axis = int(np.argmax(hi[idx].max(0) - lo[idx].min(0)))
        med = np.argsort(centers[:, axis], kind="stable")
        half = idx.size // 2
        return idx[med[:half]], idx[med[half:]]
    return idx[best[2]], idx[~best[2]]


def _build_nodes(lo: np.ndarray, hi: np.ndarray, leaf_size: int,
                 method: str = "median"):
    """Split recursion -> (nodes, primitive permutation): the longest-axis
    median split ("median", the native build's tree) or the binned SAH
    ("sah").

    A node is [min, max, first, count, skip]; children follow their
    parent in DFS order (left = i + 1)."""
    n = lo.shape[0]
    nodes: List[list] = []
    perm: List[int] = []
    ends: dict = {}

    def rec(idx: np.ndarray) -> int:
        my = len(nodes)
        bmin = lo[idx].min(axis=0)
        bmax = hi[idx].max(axis=0)
        nodes.append([bmin, bmax, -1, 0, -1])
        if idx.size > leaf_size:
            if method == "sah":
                left, right = _sah_partition(lo, hi, idx)
            else:
                centers = (lo[idx] + hi[idx]) * 0.5
                axis = int(np.argmax(bmax - bmin))  # longest axis
                med = np.argsort(centers[:, axis], kind="stable")
                half = idx.size // 2
                left, right = idx[med[:half]], idx[med[half:]]
            rec(left)
            rec(right)
        else:
            nodes[my][2] = len(perm)
            nodes[my][3] = idx.size
            perm.extend(idx.tolist())
        ends[my] = len(nodes)  # just past my subtree
        return my

    rec(np.arange(n))

    # skip pointer: the next node in DFS order outside my subtree
    def assign_skip(i: int, skip: int) -> None:
        nodes[i][4] = skip
        if nodes[i][3] == 0:
            left = i + 1
            assign_skip(left, ends[left])
            assign_skip(ends[left], skip)

    assign_skip(0, len(nodes))
    return nodes, np.asarray(perm, np.int32)


def flat_arrays(lo: np.ndarray, hi: np.ndarray, leaf_size: int,
                method: str = "median"):
    """The numpy build's tree as (node_min, node_max, node_skip,
    node_first, node_count, prim_index) arrays: with "median", the plain
    version of the native build, which returns the same arrays."""
    nodes, perm = _build_nodes(lo, hi, leaf_size, method)
    col = lambda i, dt: np.asarray([nd[i] for nd in nodes], dt)
    return (col(0, np.float32), col(1, np.float32), col(4, np.int32),
            col(2, np.int32), col(3, np.int32), perm)


def build_bvh(lo, hi, leaf_size: int = LEAF_SIZE_DEFAULT,
              device="cpu", method: str = "median") -> FlatBVH:
    """Build from per-primitive boxes (P,3) + (P,3) on the host.

    "median" takes the native build (``native.build_bvh_native``) when
    the library loaded, else the numpy one: the same tree. "sah" builds
    in numpy."""
    if method not in ("median", "sah"):
        raise ValueError(f"unknown BVH method {method!r}: 'median' or 'sah'")
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(device)
    if lo.shape[0] == 0:
        z = np.zeros((1, 3), np.float32)
        return FlatBVH(t(z, np.float32), t(z, np.float32),
                       t([1], np.int32), t([0], np.int32), t([0], np.int32),
                       t(np.zeros(0), np.int32), leaf_size=leaf_size)
    nat = None
    if method == "median":
        from . import native
        nat = native.build_bvh_native(lo, hi, leaf_size)
    nmin, nmax, nskip, nfirst, ncount, perm = (
        nat if nat is not None else flat_arrays(lo, hi, leaf_size, method))
    return FlatBVH(node_min=t(nmin, np.float32), node_max=t(nmax, np.float32),
                   node_skip=t(nskip, np.int32), node_first=t(nfirst, np.int32),
                   node_count=t(ncount, np.int32), prim_index=t(perm, np.int32),
                   leaf_size=leaf_size)


def build_sphere_bvh(centers, radii, leaf_size: int = LEAF_SIZE_DEFAULT,
                     device="cpu") -> FlatBVH:
    """A median tree over spheres' boxes (the primitive ids are sphere
    indices)."""
    r = np.asarray(radii, np.float32)[:, None]
    c = np.asarray(centers, np.float32)
    return build_bvh(c - r, c + r, leaf_size, device)


def build_triangle_bvh(v0, v1, v2, leaf_size: int = LEAF_SIZE_DEFAULT,
                       device="cpu") -> FlatBVH:
    """A median tree over triangles' boxes."""
    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    return build_bvh(np.minimum(np.minimum(v0, v1), v2),
                     np.maximum(np.maximum(v0, v1), v2), leaf_size, device)


def widen4(flat: FlatBVH):
    """Collapse a binary tree into the 4-wide layout on the host
    (``raytrace_tpu/bvh.py:widen4``): ((W,36) float32 table, stack bound).

    A binary node's children are i + 1 and that child's skip pointer. A
    wide node's slots are, per binary child, the child itself when it is a
    leaf, else its two children; an inner slot points at the wide node of
    its binary node, numbered in preorder. A slot is [min.xyz, max.xyz,
    child, first, count] (child -1 for a leaf, first -1 and count 0 for an
    inner slot); an empty slot has the corners +BIG/-BIG, child -1 and
    count 0. The stack bound is 3 * depth + 1: a pop pushes at most 3 more
    entries than it takes."""
    nmin = flat.node_min.cpu().numpy()
    nmax = flat.node_max.cpu().numpy()
    nskip = flat.node_skip.cpu().numpy()
    ncount = flat.node_count.cpu().numpy()
    nfirst = flat.node_first.cpu().numpy()
    rows: List[np.ndarray] = []

    def row(slots):
        """slots: (binary node, wide child or -1) -> one table row."""
        r = np.zeros((4, 9), np.float32)
        r[:, 0:3] = _BIG
        r[:, 3:6] = -_BIG
        r[:, 6:8] = -1.0
        for s, (b, w) in enumerate(slots):
            r[s, 0:3] = nmin[b]
            r[s, 3:6] = nmax[b]
            r[s, 6] = w
            if ncount[b] > 0:
                r[s, 7] = nfirst[b]
                r[s, 8] = ncount[b]
        return r.reshape(36)

    depth = [0]

    def rec(i: int, d: int) -> int:
        depth[0] = max(depth[0], d)
        my = len(rows)
        rows.append(None)
        slots = []
        for c in (i + 1, int(nskip[i + 1])):
            if ncount[c] > 0:
                slots.append(c)
            else:
                slots.extend((c + 1, int(nskip[c + 1])))
        rows[my] = row([(b, -1 if ncount[b] > 0 else rec(b, d + 1))
                        for b in slots])
        return my

    if nmin.shape[0] == 1 and ncount[0] == 0:
        rows.append(row([]))   # no primitives: four empty slots
    elif ncount[0] > 0:
        rows.append(row([(0, -1)]))  # the root is a leaf
    else:
        rec(0, 1)
    return np.stack(rows), 3 * max(depth[0], 1) + 1


def with_wide4(flat: FlatBVH) -> FlatBVH:
    """The tree with its 4-wide view attached, on the tree's device."""
    table, stack = widen4(flat)
    return dataclasses.replace(
        flat, wide4=torch.from_numpy(table).to(flat.node_min.device),
        wide_stack=stack)


def wide_walk(bvh: FlatBVH) -> bool:
    """Do the walks of this tree take the 4-wide layout? As the JAX
    kernel decides (``trace_pallas`` :3071, :3113-3118): always in bvh
    mode, and in stream mode (a tree with the stream table) within
    WIDE_STREAM_BUDGET; besides, the stack bound must fit WIDE_STACK.
    A median-split tree up to the stream cap always fits; an SAH tree
    (or any other topology) may not, and then walks binary: the kernels'
    4-wide walks (csrc/bvh_walk.cuh, csrc/stream_walk.cuh) drop a child
    that finds their stack full, so such a tree must never reach them.
    Every walk table and trace table takes its layout from here."""
    if bvh.wide4 is None or bvh.wide_stack + 4 > WIDE_STACK:
        return False
    if bvh.stream_tab is None:
        return True
    return 4 * (9 * bvh.n_nodes + bvh.wide4.numel()
                + 128 * bvh.leaf_size) <= WIDE_STREAM_BUDGET


def build_scene_bvh(geom, leaf_size: int = LEAF_SIZE_DEFAULT,
                    method: str = "median") -> FlatBVH:
    """One tree over a Geometry's spheres and then its triangles (cube
    faces included), on the geometry's device, with its 4-wide view;
    planes are unbounded and stay outside it. ``method``: build_bvh's
    split ("sah" for a tree the scene loaders never build, which a caller
    attaches with ``dataclasses.replace(scene, accel=...)``)."""
    host = lambda x: x.detach().cpu().numpy()
    c, r = host(geom.sph_center), host(geom.sph_radius)[:, None]
    v0, v1, v2 = host(geom.tri_v0), host(geom.tri_v1), host(geom.tri_v2)
    lo = np.concatenate([c - r, np.minimum(np.minimum(v0, v1), v2)], axis=0)
    hi = np.concatenate([c + r, np.maximum(np.maximum(v0, v1), v2)], axis=0)
    return with_wide4(build_bvh(lo, hi, leaf_size,
                                device=geom.sph_center.device,
                                method=method))


# ------------------------------------------------------------- walks ----

def _safe_inverse(direction):
    return 1.0 / torch.where(direction == 0.0,
                             torch.full_like(direction, 1e-30), direction)


def _box_hit(bmin, bmax, o, inv_d, t_min, t_max):
    """(A,) slab test of one box per lane, near clamped to t_min and far
    to t_max (bvh._aabb_hit)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=t_min)
    far = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=-1), t_max)
    return near <= far


class _Leaves:
    """Per-lane gathers of the primitives in each lane's current leaf, by
    primitive id from the scene tables (bvh mode). A slot's key is its
    primitive id."""

    def __init__(self, bvh: FlatBVH, geom):
        self.ns = geom.sph_center.shape[0]
        self.nt = geom.tri_v0.shape[0]
        self.nt_occl = geom.n_hit_tris  # cube faces [occl, nt) masked
        self.geom = geom
        self.bvh = bvh
        if self.nt:
            self.e1 = geom.tri_v1 - geom.tri_v0
            self.e2 = geom.tri_v2 - geom.tri_v0
        self.slots = torch.arange(bvh.leaf_size,
                                  device=bvh.prim_index.device)

    def gather(self, first, count):
        """(key (A,L), valid slot (A,L)) of the leaves at first/count."""
        p = self.bvh.prim_index
        slot = torch.clamp(first[:, None] + self.slots, max=p.shape[0] - 1)
        return p[slot].to(torch.int64), self.slots < count[:, None]

    def prim_id(self, key):
        return key

    def closest_t(self, o, d, pid, t_min, t_max):
        """(A,L) hit distances of the slots' primitives, BIG where none
        (and for cube faces)."""
        g, ns, nt = self.geom, self.ns, self.nt
        t = None
        if ns:
            si = torch.clamp(pid, max=ns - 1)
            t = intersect.sphere_t(o, d, g.sph_center[si], g.sph_radius[si],
                                   t_min, t_max)
        if nt:
            ti = torch.clamp(pid - ns, 0, nt - 1)
            tt = intersect.triangle_t(o, d, g.tri_v0[ti], self.e1[ti],
                                      self.e2[ti], t_min, t_max)
            tt = torch.where(ti < self.nt_occl, tt, intersect.BIG)
            t = tt if t is None else torch.where(pid < ns, t, tt)
        return t

    def blocked(self, o, d, pid, t_min, t_max, exact):
        """(A,L) occlusion verdicts of the slots' primitives."""
        g, ns, nt = self.geom, self.ns, self.nt
        hit = None
        if ns:
            si = torch.clamp(pid, max=ns - 1)
            hit = intersect.sphere_t(o, d, g.sph_center[si], g.sph_radius[si],
                                     t_min, t_max) < intersect.BIG
        if nt:
            ti = torch.clamp(pid - ns, 0, nt - 1)
            args = (o, d, g.tri_v0[ti], self.e1[ti], self.e2[ti], t_min,
                    t_max)
            if exact:
                ht = intersect.triangle_t(*args) < intersect.BIG
            else:
                ht = intersect.triangle_blocked(*args)
            ht = ht & (ti < self.nt_occl)
            hit = ht if hit is None else torch.where(pid < ns, hit, ht)
        return hit


class _RowLeaves:
    """The same gathers from the unified rows of the stream table (stream
    mode: the plain version of K5's leaf reads). A leaf's rows are
    [first, first + count) in slot order; a slot's key is its row. Tag 0
    is a sphere (center in cols 1-3, radius in col 4), 1 a triangle (v0,
    e1, e2 in cols 1-9), 2 a cube face and -1 padding, which no test
    takes: boxes are the hit form of cubes. The floats are those of the
    scene tables, so every verdict is the bvh-mode walk's."""

    def __init__(self, bvh: FlatBVH):
        self.bvh = bvh
        self.rows = bvh.stream_tab[:, :10].contiguous()
        self.slots = torch.arange(bvh.leaf_size,
                                  device=bvh.prim_index.device)

    def gather(self, first, count):
        # the table ends in leaf_size padding rows: no slot runs past it
        return first[:, None] + self.slots, self.slots < count[:, None]

    def prim_id(self, key):
        p = self.bvh.prim_index
        return p[torch.clamp(key, max=p.shape[0] - 1)].to(torch.int64)

    def _split(self, key):
        r = self.rows[key]                                   # (A,L,10)
        return r[..., 0], r[..., 1:4], r[..., 4:7], r[..., 7:10]

    def closest_t(self, o, d, key, t_min, t_max):
        tag, v0, e1, e2 = self._split(key)
        ts = intersect.sphere_t(o, d, v0, e1[..., 0], t_min, t_max)
        tt = intersect.triangle_t(o, d, v0, e1, e2, t_min, t_max)
        return torch.where(tag == 0, ts,
                           torch.where(tag == 1, tt, intersect.BIG))

    def blocked(self, o, d, key, t_min, t_max, exact):
        tag, v0, e1, e2 = self._split(key)
        hs = intersect.sphere_t(o, d, v0, e1[..., 0], t_min,
                                t_max) < intersect.BIG
        args = (o, d, v0, e1, e2, t_min, t_max)
        if exact:
            ht = intersect.triangle_t(*args) < intersect.BIG
        else:
            ht = intersect.triangle_blocked(*args)
        return torch.where(tag == 0, hs, ht & (tag == 1))


class WalkLeaves:
    """The same gathers from the leaf rows of K3+K4's walk table
    (``megakernel.pack_walk_table``): a (P, 12) float32 table, row r the
    primitive of leaf slot r - v0, e1, e2 (a sphere: center, radius in
    col 3), tag (0 sphere, 1 triangle, 2 cube face, which no test takes),
    id (its row in the sphere or triangle table), 0. A slot's key is its
    row; prim_id gives the tree's primitive id (spheres first, then
    ``ns`` + triangle)."""

    def __init__(self, rows: torch.Tensor, leaf_size: int, ns: int):
        self.rows = rows
        self.ns = ns
        self.slots = torch.arange(leaf_size, device=rows.device)

    def gather(self, first, count):
        key = torch.clamp(first[:, None] + self.slots,
                          max=self.rows.shape[0] - 1)
        return key, self.slots < count[:, None]

    def prim_id(self, key):
        r = self.rows[key]
        return torch.where(r[..., 9] == 0, r[..., 10],
                           self.ns + r[..., 10]).to(torch.int64)

    def _split(self, key):
        r = self.rows[key]                                   # (A,L,12)
        return r[..., 9], r[..., 0:3], r[..., 3:6], r[..., 6:9]

    def closest_t(self, o, d, key, t_min, t_max):
        tag, v0, e1, e2 = self._split(key)
        ts = intersect.sphere_t(o, d, v0, e1[..., 0], t_min, t_max)
        tt = intersect.triangle_t(o, d, v0, e1, e2, t_min, t_max)
        return torch.where(tag == 0, ts,
                           torch.where(tag == 1, tt, intersect.BIG))

    def blocked(self, o, d, key, t_min, t_max, exact):
        tag, v0, e1, e2 = self._split(key)
        hs = intersect.sphere_t(o, d, v0, e1[..., 0], t_min,
                                t_max) < intersect.BIG
        args = (o, d, v0, e1, e2, t_min, t_max)
        if exact:
            ht = intersect.triangle_t(*args) < intersect.BIG
        else:
            ht = intersect.triangle_blocked(*args)
        return torch.where(tag == 0, hs, ht & (tag == 1))


def walk_view(nodes: torch.Tensor, n_nodes: int, n_wide: int,
              leaf_size: int) -> FlatBVH:
    """The tree of a walk table's node part: (W,36) 4-wide rows when
    n_wide > 0 (the binary fields are then empty), else (N,9) binary rows
    [min.xyz, max.xyz, skip, first, count]."""
    dev = nodes.device
    if n_wide > 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return FlatBVH(node_min=torch.zeros((n_nodes, 3), device=dev),
                       node_max=torch.zeros((n_nodes, 3), device=dev),
                       node_skip=empty, node_first=empty, node_count=empty,
                       prim_index=empty, leaf_size=leaf_size,
                       wide4=nodes.reshape(n_wide, 36),
                       wide_stack=WIDE_STACK - 4)
    nd = nodes.reshape(n_nodes, 9)
    col = lambda c: nd[:, c].to(torch.int32)
    return FlatBVH(node_min=nd[:, 0:3], node_max=nd[:, 3:6],
                   node_skip=col(6), node_first=col(7), node_count=col(8),
                   prim_index=torch.zeros((0,), dtype=torch.int32,
                                          device=dev),
                   leaf_size=leaf_size)


def _leaves(bvh: FlatBVH, geom, leaves=None):
    """The walk's leaf reads: ``leaves`` when given, the stream table's
    rows when the tree carries one (stream mode), else the scene tables by
    primitive id."""
    if leaves is not None:
        return leaves
    if bvh.stream_tab is not None:
        return _RowLeaves(bvh)
    return _Leaves(bvh, geom)


def traverse_closest(bvh: FlatBVH, geom, origin, direction, t_min=1e-3,
                     t_max=intersect.BIG, leaves=None):
    """Closest hit over the tree's spheres and triangles: (t, pid) with
    t = BIG and pid = -1 where nothing beats t_max.

    Lockstep skip walk: a box hit moves a lane's cursor to the next node,
    a miss to the node's skip pointer; a leaf's primitives are tested in
    slot order and a hit is taken only when t < t_best. The slots of a
    leaf are tested at once against the t_best the lane entered with:
    the first minimum among them is what the one-by-one scan keeps."""
    B = origin.shape[0]
    dev = origin.device
    n = bvh.n_nodes
    inv_d = _safe_inverse(direction)
    t_best = torch.clamp(torch.as_tensor(t_max, dtype=origin.dtype,
                                         device=dev).expand(B),
                         max=intersect.BIG).clone()
    best = torch.full((B,), -1, dtype=torch.int64, device=dev)
    cursor = torch.zeros(B, dtype=torch.int64, device=dev)
    leaves = _leaves(bvh, geom, leaves)
    act = torch.arange(B, device=dev)
    while act.numel():
        cur = cursor[act]
        o, d, tb = origin[act], direction[act], t_best[act]
        box = _box_hit(bvh.node_min[cur], bvh.node_max[cur], o, inv_d[act],
                       t_min, tb)
        cnt = bvh.node_count[cur]
        leaf = cnt > 0
        at = (box & leaf).nonzero()[:, 0]
        if at.numel():
            key, valid = leaves.gather(bvh.node_first[cur[at]], cnt[at])
            t = leaves.closest_t(o[at], d[at], key, t_min, tb[at])
            t = torch.where(valid, t, intersect.BIG)
            j = torch.argmin(t, dim=-1, keepdim=True)
            tj = torch.gather(t, 1, j)[:, 0]
            won = tj < tb[at]
            lanes = act[at[won]]
            t_best[lanes] = tj[won]
            best[lanes] = leaves.prim_id(torch.gather(key, 1, j)[:, 0][won])
        nxt = torch.where(box & ~leaf, cur + 1,
                          bvh.node_skip[cur].to(torch.int64))
        cursor[act] = nxt
        act = act[nxt < n]
    return torch.where(best >= 0, t_best, intersect.BIG), best


def traverse_closest_wide(bvh: FlatBVH, geom, origin, direction,
                          t_min=1e-3, t_max=intersect.BIG, leaves=None):
    """``traverse_closest`` over the 4-wide layout: the plain version of
    K3-wide's closest-hit walk (``closest_fn_wide`` :1000), in its order.

    Each lane pops a wide node off its stack, slab-tests the 4 slots
    against the t_best it popped with, runs the boxed leaf slots in slot
    order and pushes the boxed inner slots in slot order (the last pushed
    is popped first). The boxed leaves' slots are tested at once against
    that t_best: their first minimum is what the one-by-one scan keeps."""
    B = origin.shape[0]
    dev = origin.device
    inv_d = _safe_inverse(direction)
    t_best = torch.clamp(torch.as_tensor(t_max, dtype=origin.dtype,
                                         device=dev).expand(B),
                         max=intersect.BIG).clone()
    best = torch.full((B,), -1, dtype=torch.int64, device=dev)
    w = bvh.wide4.view(-1, 4, 9)
    lo, hi = w[..., 0:3], w[..., 3:6]
    child, first, count = (w[..., c].to(torch.int64) for c in (6, 7, 8))
    stack = torch.zeros((B, bvh.wide_stack + 4), dtype=torch.int64,
                        device=dev)
    sp = torch.ones(B, dtype=torch.int64, device=dev)
    leaves = _leaves(bvh, geom, leaves)
    L = bvh.leaf_size
    act = torch.arange(B, device=dev)
    while act.numel():
        sa = sp[act] - 1
        cur = stack[act, sa]
        o, d, tb = origin[act], direction[act], t_best[act]
        box = _box_hit(lo[cur], hi[cur], o[:, None], inv_d[act][:, None],
                       t_min, tb[:, None])                         # (A,4)
        leaf = box & (count[cur] > 0)
        at = leaf.any(dim=-1).nonzero()[:, 0]
        if at.numel():
            c = cur[at]
            key, valid = leaves.gather(first[c].clamp(min=0).reshape(-1),
                                       count[c].reshape(-1))
            key = key.view(-1, 4 * L)
            valid = (valid.view(-1, 4, L) & leaf[at][..., None]).view(
                -1, 4 * L)
            t = leaves.closest_t(o[at], d[at], key, t_min, tb[at])
            t = torch.where(valid, t, intersect.BIG)
            j = torch.argmin(t, dim=-1, keepdim=True)
            tj = torch.gather(t, 1, j)[:, 0]
            won = tj < tb[at]
            lanes = act[at[won]]
            t_best[lanes] = tj[won]
            best[lanes] = leaves.prim_id(torch.gather(key, 1, j)[:, 0][won])
        for s in range(4):
            push = box[:, s] & (child[cur, s] >= 0)
            stack[act, sa] = torch.where(push, child[cur, s],
                                         stack[act, sa])
            sa = sa + push.to(torch.int64)
        sp[act] = sa
        act = act[sa > 0]
    return torch.where(best >= 0, t_best, intersect.BIG), best


def traverse_any(bvh: FlatBVH, geom, origin, direction, t_min, t_max,
                 exact: bool = False, leaves=None):
    """(B,) bool: does a tree primitive block [t_min, t_max]? A blocked
    lane ends its walk at once. ``exact`` tests triangles with the
    closest-hit expressions (see intersect.any_hit)."""
    B = origin.shape[0]
    dev = origin.device
    n = bvh.n_nodes
    inv_d = _safe_inverse(direction)
    tm = torch.as_tensor(t_max, dtype=origin.dtype, device=dev).expand(B)
    blocked = torch.zeros(B, dtype=torch.bool, device=dev)
    cursor = torch.zeros(B, dtype=torch.int64, device=dev)
    leaves = _leaves(bvh, geom, leaves)
    act = torch.arange(B, device=dev)
    while act.numel():
        cur = cursor[act]
        o, d, tma = origin[act], direction[act], tm[act]
        box = _box_hit(bvh.node_min[cur], bvh.node_max[cur], o, inv_d[act],
                       t_min, tma)
        cnt = bvh.node_count[cur]
        leaf = cnt > 0
        at = (box & leaf).nonzero()[:, 0]
        hit = torch.zeros_like(box)
        if at.numel():
            key, valid = leaves.gather(bvh.node_first[cur[at]], cnt[at])
            h = leaves.blocked(o[at], d[at], key, t_min, tma[at], exact)
            hit[at] = torch.any(h & valid, dim=-1)
        blocked[act[hit]] = True
        nxt = torch.where(box & ~leaf, cur + 1,
                          bvh.node_skip[cur].to(torch.int64))
        nxt = torch.where(hit, n, nxt)
        cursor[act] = nxt
        act = act[nxt < n]
    return blocked


def traverse_any_wide(bvh: FlatBVH, geom, origin, direction, t_min, t_max,
                      exact: bool = False, leaves=None):
    """``traverse_any`` over the 4-wide layout, in the order of the
    kernels' 4-wide shadow walks: each lane pops a wide node, slab-tests
    its 4 slots, tests the boxed leaf slots' primitives and pushes the
    boxed inner slots; a blocked lane ends its walk. The same verdicts as
    ``traverse_any``."""
    B = origin.shape[0]
    dev = origin.device
    inv_d = _safe_inverse(direction)
    tm = torch.as_tensor(t_max, dtype=origin.dtype, device=dev).expand(B)
    blocked = torch.zeros(B, dtype=torch.bool, device=dev)
    w = bvh.wide4.view(-1, 4, 9)
    lo, hi = w[..., 0:3], w[..., 3:6]
    child, first, count = (w[..., c].to(torch.int64) for c in (6, 7, 8))
    stack = torch.zeros((B, bvh.wide_stack + 4), dtype=torch.int64,
                        device=dev)
    sp = torch.ones(B, dtype=torch.int64, device=dev)
    leaves = _leaves(bvh, geom, leaves)
    L = bvh.leaf_size
    act = torch.arange(B, device=dev)
    while act.numel():
        sa = sp[act] - 1
        cur = stack[act, sa]
        o, d, tma = origin[act], direction[act], tm[act]
        box = _box_hit(lo[cur], hi[cur], o[:, None], inv_d[act][:, None],
                       t_min, tma[:, None])                        # (A,4)
        leaf = box & (count[cur] > 0)
        at = leaf.any(dim=-1).nonzero()[:, 0]
        hit = torch.zeros(act.shape[0], dtype=torch.bool, device=dev)
        if at.numel():
            c = cur[at]
            key, valid = leaves.gather(first[c].clamp(min=0).reshape(-1),
                                       count[c].reshape(-1))
            key = key.view(-1, 4 * L)
            valid = (valid.view(-1, 4, L) & leaf[at][..., None]).view(
                -1, 4 * L)
            h = leaves.blocked(o[at], d[at], key, t_min, tma[at], exact)
            hit[at] = torch.any(h & valid, dim=-1)
        blocked[act[hit]] = True
        for s in range(4):
            push = box[:, s] & (child[cur, s] >= 0)
            stack[act, sa] = torch.where(push, child[cur, s],
                                         stack[act, sa])
            sa = sa + push.to(torch.int64)
        sa = torch.where(hit, torch.zeros_like(sa), sa)
        sp[act] = sa
        act = act[sa > 0]
    return blocked


# ------------------------------------------- sphere-tree closest hit ----

def sphere_hit_t(origin, direction, center, radius, t_min, t_best):
    """(B,) hit distance of one sphere a lane (BIG where none): the
    operations of ``intersect.sphere_t`` (a multiply by 1/a, the same
    root guard), so the walk takes brute force's hits."""
    oc = origin - center
    a = intersect._dot(direction, direction)
    half_b = intersect._dot(oc, direction)
    c = intersect._dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
    inv_a = 1.0 / a
    r0 = (-half_b - sq) * inv_a
    r1 = (-half_b + sq) * inv_a
    in0 = ok & (r0 >= t_min) & (r0 <= t_best)
    in1 = ok & (r1 >= t_min) & (r1 <= t_best)
    return torch.where(in0, r0, torch.where(in1, r1, intersect.BIG))


def tri_hit_t(origin, direction, v0, e1, e2, t_min, t_best):
    """(B,) Moller-Trumbore distance of one triangle a lane (BIG where
    none): the operations of ``intersect.triangle_t``, with its 1e-6
    determinant test."""
    h = intersect._cross(direction, e2)
    a = intersect._dot(e1, h)
    degen = torch.abs(a) < 1e-6
    f = 1.0 / torch.where(degen, torch.ones_like(a), a)
    s = origin - v0
    u = f * intersect._dot(s, h)
    q = intersect._cross(s, e1)
    v = f * intersect._dot(direction, q)
    t = f * intersect._dot(e2, q)
    valid = ((~degen) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t >= t_min) & (t <= t_best))
    return torch.where(valid, t, intersect.BIG)


def closest_hit_bvh(bvh: FlatBVH, centers, radii, origin, direction,
                    t_min=1e-3, max_leaf: Optional[int] = None):
    """Closest hit of (B,3) rays over a sphere tree: (t, sphere id), t =
    BIG and id = -1 on a miss. Plain PyTorch on the rays' device (the
    tree, centers and radii must be there too).

    The skip walk of ``traverse_closest``: a box hit moves a lane's
    cursor to the next node, a miss to the skip pointer; a leaf's first
    ``max_leaf`` slots (default: the tree's leaf size) are tested against
    the t_best the lane entered with, and their first minimum below it
    wins, as the JAX function's slot-by-slot loop keeps."""
    L = bvh.leaf_size if max_leaf is None else max_leaf
    B = origin.shape[0]
    dev = origin.device
    n = bvh.n_nodes
    inv_d = _safe_inverse(direction)
    t_best = torch.full((B,), float(_BIG), dtype=torch.float32, device=dev)
    best = torch.full((B,), -1, dtype=torch.int64, device=dev)
    cursor = torch.zeros(B, dtype=torch.int64, device=dev)
    slots = torch.arange(L, device=dev)
    p = bvh.prim_index
    act = torch.arange(B, device=dev)
    while act.numel():
        cur = cursor[act]
        o, d, tb = origin[act], direction[act], t_best[act]
        box = _box_hit(bvh.node_min[cur], bvh.node_max[cur], o, inv_d[act],
                       t_min, tb)
        cnt = bvh.node_count[cur]
        leaf = cnt > 0
        at = (box & leaf).nonzero()[:, 0]
        if at.numel():
            slot = torch.clamp(bvh.node_first[cur[at]][:, None] + slots,
                               max=p.shape[0] - 1)
            pid = p[slot].to(torch.int64)                        # (A,L)
            oa, da = o[at][:, None].expand(-1, L, -1), d[at][:, None]
            t = sphere_hit_t(oa, da.expand(-1, L, -1), centers[pid],
                             radii[pid], t_min, tb[at][:, None])
            t = torch.where(slots < cnt[at][:, None], t, intersect.BIG)
            j = torch.argmin(t, dim=-1, keepdim=True)
            tj = torch.gather(t, 1, j)[:, 0]
            won = tj < tb[at]
            lanes = act[at[won]]
            t_best[lanes] = tj[won]
            best[lanes] = torch.gather(pid, 1, j)[:, 0][won]
        nxt = torch.where(box & ~leaf, cur + 1,
                          bvh.node_skip[cur].to(torch.int64))
        cursor[act] = nxt
        act = act[nxt < n]
    return t_best, best


# ---------------------------------------------------- host trees ----

def _ray_aabb_host(o: np.ndarray, d: np.ndarray, lo, hi,
                   t_min: float, t_max: float) -> bool:
    """Scalar float64 slab test of one ray and one box on the host."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / np.where(d == 0.0, 1e-300, d)
    t0 = (np.asarray(lo, np.float64) - o) * inv
    t1 = (np.asarray(hi, np.float64) - o) * inv
    near = max(float(np.minimum(t0, t1).max()), t_min)
    far = min(float(np.maximum(t0, t1).min()), t_max)
    return near <= far


@dataclasses.dataclass
class OctreeNode:
    center: np.ndarray
    half: float
    depth: int
    indices: List[int]
    children: Optional[List["OctreeNode"]] = None


class Octree:
    """Host octree over boxes: an object lives at the deepest node whose
    cube holds its box (children are the +-half/2 octants), and a node
    past ``max_objects`` subdivides until ``max_depth``."""

    def __init__(self, lo: np.ndarray, hi: np.ndarray,
                 max_depth: int = 8, max_objects: int = 8):
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)
        self.max_depth = max_depth
        self.max_objects = max_objects
        world_lo = self.lo.min(axis=0) if len(self.lo) else np.zeros(3)
        world_hi = self.hi.max(axis=0) if len(self.hi) else np.ones(3)
        center = (world_lo + world_hi) / 2.0
        half = float((world_hi - world_lo).max() / 2.0) or 1.0
        self.root = OctreeNode(center, half, 0, [])
        for i in range(len(self.lo)):
            self._insert(self.root, i)

    def _fits_child(self, node: OctreeNode, i: int, octant: int) -> bool:
        c = self._child_center(node, octant)
        h = node.half / 2.0
        return bool(np.all(self.lo[i] >= c - h)
                    and np.all(self.hi[i] <= c + h))

    @staticmethod
    def _child_center(node: OctreeNode, octant: int) -> np.ndarray:
        h = node.half / 2.0
        return node.center + np.array([h if octant & 1 else -h,
                                       h if octant & 2 else -h,
                                       h if octant & 4 else -h])

    def _insert(self, node: OctreeNode, i: int) -> None:
        if node.children is None:
            node.indices.append(i)
            if (len(node.indices) > self.max_objects
                    and node.depth < self.max_depth):
                self._subdivide(node)
            return
        for octant in range(8):
            if self._fits_child(node, i, octant):
                self._insert(node.children[octant], i)
                return
        node.indices.append(i)  # straddles children: stays here

    def _subdivide(self, node: OctreeNode) -> None:
        node.children = [OctreeNode(self._child_center(node, o),
                                    node.half / 2.0, node.depth + 1, [])
                         for o in range(8)]
        staying = []
        for i in node.indices:
            for octant in range(8):
                if self._fits_child(node, i, octant):
                    node.children[octant].indices.append(i)
                    break
            else:
                staying.append(i)
        node.indices = staying

    def query_point(self, p) -> List[int]:
        """Objects whose box holds p."""
        p = np.asarray(p, np.float64)
        out: List[int] = []

        def rec(node: OctreeNode):
            if np.any(np.abs(p - node.center) > node.half):
                return
            for i in node.indices:
                if np.all(self.lo[i] <= p) and np.all(p <= self.hi[i]):
                    out.append(i)
            for ch in node.children or ():
                rec(ch)

        rec(self.root)
        return sorted(out)

    def query_ray(self, origin, direction, t_min: float = 1e-3,
                  t_max: float = float(_BIG)) -> List[int]:
        """Objects whose box the ray hits in [t_min, t_max]; a node whose
        cube the ray misses is pruned (it holds every box below it)."""
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        out: List[int] = []

        def rec(node: OctreeNode):
            if not _ray_aabb_host(o, d, node.center - node.half,
                                  node.center + node.half, t_min, t_max):
                return
            for i in node.indices:
                if _ray_aabb_host(o, d, self.lo[i], self.hi[i], t_min,
                                  t_max):
                    out.append(i)
            for ch in node.children or ():
                rec(ch)

        rec(self.root)
        return sorted(out)

    def closest_hit(self, origin, direction, hit_t, t_min: float = 1e-3,
                    t_max: float = float(_BIG)) -> Tuple[float, int]:
        """(t, index) of the closest object, or (BIG, -1); ``hit_t(i,
        t_min, t_max)`` gives an object's hit distance or +inf. Cubes are
        pruned against the best t so far."""
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        best = [float(t_max), -1]

        def rec(node: OctreeNode):
            if not _ray_aabb_host(o, d, node.center - node.half,
                                  node.center + node.half, t_min, best[0]):
                return
            for i in node.indices:
                t = hit_t(i, t_min, best[0])
                if t_min <= t < best[0]:
                    best[0], best[1] = float(t), i
            for ch in node.children or ():
                rec(ch)

        rec(self.root)
        return (best[0], best[1]) if best[1] >= 0 else (float(_BIG), -1)

    def node_count(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children or ())
        return n


@dataclasses.dataclass
class KDNode:
    axis: int
    split: float
    indices: List[int]
    left: Optional["KDNode"] = None
    right: Optional["KDNode"] = None
    # the union of the objects' boxes below: traversal gates on it, so an
    # object whose box crosses the split plane is never missed
    box_lo: Optional[np.ndarray] = None
    box_hi: Optional[np.ndarray] = None


class KDTree:
    """Host k-d tree over box centroids: the axis is depth mod 3, the
    split the centroids' midpoint, a leaf at most ``leaf_size`` objects
    or at ``max_depth``."""

    def __init__(self, lo: np.ndarray, hi: np.ndarray,
                 max_depth: int = 16, leaf_size: int = 8):
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)
        self.centers = (self.lo + self.hi) / 2.0
        self.leaf_size = leaf_size
        self.max_depth = max_depth
        self.root = self._build(list(range(len(self.lo))), 0)

    def _build(self, idx: List[int], depth: int) -> Optional[KDNode]:
        if not idx:
            return None
        blo = self.lo[idx].min(axis=0)
        bhi = self.hi[idx].max(axis=0)
        axis = depth % 3
        if len(idx) <= self.leaf_size or depth >= self.max_depth:
            return KDNode(axis, 0.0, idx, box_lo=blo, box_hi=bhi)
        vals = self.centers[idx, axis]
        split = float((vals.min() + vals.max()) / 2.0)
        left = [i for i in idx if self.centers[i, axis] < split]
        right = [i for i in idx if self.centers[i, axis] >= split]
        if not left or not right:  # degenerate: a leaf
            return KDNode(axis, split, idx, box_lo=blo, box_hi=bhi)
        return KDNode(axis, split, [], self._build(left, depth + 1),
                      self._build(right, depth + 1), box_lo=blo, box_hi=bhi)

    def query_range(self, lo, hi) -> List[int]:
        """Objects whose box overlaps [lo, hi]."""
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        out: List[int] = []

        def rec(node: Optional[KDNode]):
            if node is None:
                return
            if node.left is None and node.right is None:
                out.extend(i for i in node.indices
                           if np.all(self.lo[i] <= hi)
                           and np.all(lo <= self.hi[i]))
                return
            if lo[node.axis] < node.split:
                rec(node.left)
            if hi[node.axis] >= node.split:
                rec(node.right)

        rec(self.root)
        return sorted(out)

    def _ordered_children(self, node: KDNode, o, d):
        """(near, far) children for a ray."""
        if d[node.axis] > 0 or (d[node.axis] == 0
                                and o[node.axis] < node.split):
            return node.left, node.right
        return node.right, node.left

    def query_ray(self, origin, direction, t_min: float = 1e-3,
                  t_max: float = float(_BIG)) -> List[int]:
        """Objects whose box the ray hits in [t_min, t_max]: near/far
        descent gated on the nodes' boxes."""
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        out: List[int] = []

        def rec(node: Optional[KDNode]):
            if node is None or not _ray_aabb_host(o, d, node.box_lo,
                                                  node.box_hi, t_min, t_max):
                return
            if node.left is None and node.right is None:
                out.extend(i for i in node.indices
                           if _ray_aabb_host(o, d, self.lo[i], self.hi[i],
                                             t_min, t_max))
                return
            near, far = self._ordered_children(node, o, d)
            rec(near)
            rec(far)

        rec(self.root)
        return sorted(out)

    def closest_hit(self, origin, direction, hit_t, t_min: float = 1e-3,
                    t_max: float = float(_BIG)) -> Tuple[float, int]:
        """(t, index) of the closest object, or (BIG, -1): near child
        first, so the far child's box is pruned against a closer t."""
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        best = [float(t_max), -1]

        def rec(node: Optional[KDNode]):
            if node is None or not _ray_aabb_host(o, d, node.box_lo,
                                                  node.box_hi, t_min,
                                                  best[0]):
                return
            if node.left is None and node.right is None:
                for i in node.indices:
                    t = hit_t(i, t_min, best[0])
                    if t_min <= t < best[0]:
                        best[0], best[1] = float(t), i
                return
            near, far = self._ordered_children(node, o, d)
            rec(near)
            rec(far)

        rec(self.root)
        return (best[0], best[1]) if best[1] >= 0 else (float(_BIG), -1)

    def depth(self) -> int:
        def rec(node, d):
            if node is None:
                return d
            return max(rec(node.left, d + 1), rec(node.right, d + 1))
        return rec(self.root, 0)
