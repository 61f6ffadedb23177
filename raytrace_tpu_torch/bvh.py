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
``t < t_best`` acceptance, so equal-``t`` ties resolve the same way.

Not ported: the 4-wide collapse (``widen4``), SAH, the Octree and the
KD-tree (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .ops import intersect

BVH_THRESHOLD = 64       # from_dict builds a tree from this many prims
LEAF_SIZE_DEFAULT = 16   # primitives per leaf at most


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

    @property
    def n_nodes(self) -> int:
        return int(self.node_min.shape[0])

    def to(self, device) -> "FlatBVH":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _build_nodes(lo: np.ndarray, hi: np.ndarray, leaf_size: int):
    """Median split recursion -> (nodes, primitive permutation).

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
            centers = (lo[idx] + hi[idx]) * 0.5
            axis = int(np.argmax(bmax - bmin))  # longest axis
            med = np.argsort(centers[:, axis], kind="stable")
            half = idx.size // 2
            rec(idx[med[:half]])
            rec(idx[med[half:]])
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


def build_bvh(lo, hi, leaf_size: int = LEAF_SIZE_DEFAULT,
              device="cpu") -> FlatBVH:
    """Build from per-primitive boxes (P,3) + (P,3) on the host."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(device)
    if lo.shape[0] == 0:
        z = np.zeros((1, 3), np.float32)
        return FlatBVH(t(z, np.float32), t(z, np.float32),
                       t([1], np.int32), t([0], np.int32), t([0], np.int32),
                       t(np.zeros(0), np.int32), leaf_size=leaf_size)
    nodes, perm = _build_nodes(lo, hi, leaf_size)
    col = lambda i, dt: t([nd[i] for nd in nodes], dt)
    return FlatBVH(node_min=col(0, np.float32), node_max=col(1, np.float32),
                   node_skip=col(4, np.int32), node_first=col(2, np.int32),
                   node_count=col(3, np.int32), prim_index=t(perm, np.int32),
                   leaf_size=leaf_size)


def build_scene_bvh(geom, leaf_size: int = LEAF_SIZE_DEFAULT) -> FlatBVH:
    """One tree over a Geometry's spheres and then its triangles (cube
    faces included), on the geometry's device; planes are unbounded and
    stay outside it."""
    host = lambda x: x.detach().cpu().numpy()
    c, r = host(geom.sph_center), host(geom.sph_radius)[:, None]
    v0, v1, v2 = host(geom.tri_v0), host(geom.tri_v1), host(geom.tri_v2)
    lo = np.concatenate([c - r, np.minimum(np.minimum(v0, v1), v2)], axis=0)
    hi = np.concatenate([c + r, np.maximum(np.maximum(v0, v1), v2)], axis=0)
    return build_bvh(lo, hi, leaf_size, device=geom.sph_center.device)


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
    """Per-lane gathers of the primitives in each lane's current leaf."""

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
        """(pid (A,L), valid slot (A,L)) of the leaves at first/count."""
        p = self.bvh.prim_index
        slot = torch.clamp(first[:, None] + self.slots, max=p.shape[0] - 1)
        return p[slot].to(torch.int64), self.slots < count[:, None]

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


def traverse_closest(bvh: FlatBVH, geom, origin, direction, t_min=1e-3,
                     t_max=intersect.BIG):
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
    leaves = _Leaves(bvh, geom)
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
            pid, valid = leaves.gather(bvh.node_first[cur[at]], cnt[at])
            t = leaves.closest_t(o[at], d[at], pid, t_min, tb[at])
            t = torch.where(valid, t, intersect.BIG)
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
    return torch.where(best >= 0, t_best, intersect.BIG), best


def traverse_any(bvh: FlatBVH, geom, origin, direction, t_min, t_max,
                 exact: bool = False):
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
    leaves = _Leaves(bvh, geom)
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
            pid, valid = leaves.gather(bvh.node_first[cur[at]], cnt[at])
            h = leaves.blocked(o[at], d[at], pid, t_min, tma[at], exact)
            hit[at] = torch.any(h & valid, dim=-1)
        blocked[act[hit]] = True
        nxt = torch.where(box & ~leaf, cur + 1,
                          bvh.node_skip[cur].to(torch.int64))
        nxt = torch.where(hit, n, nxt)
        cursor[act] = nxt
        act = act[nxt < n]
    return blocked
