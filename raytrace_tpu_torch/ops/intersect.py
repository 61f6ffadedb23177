"""Closest-hit and any-hit tests: the plain PyTorch form.

Port of ``raytrace_tpu/ops/intersect.py``: batched lane x primitive tests
with an argmin reduction, or, given a scene BVH (``accel``), the tree walks
of ``bvh.py`` for spheres and triangles with planes and boxes still tested
brute force. Conventions carried over:
ray directions are not normalised (the sphere quadratic uses a = |d|^2);
acceptance is t_min <= t <= t_max; the triangle determinant epsilon is
1e-6; t_min is 1e-3 everywhere. Closest hit keeps the first minimum in
the order [spheres, triangles, planes, boxes]; the triangle any-hit is the
division-free form (``triangle_blocked``). Every dot product sums x, y, z
in that order, as the JAX package's reductions do, so both packages agree
bit for bit where the operations are IEEE.

Reverse mode (``diff.py``) differentiates the closest hit through the hit
distance of the winning primitive. Two guards keep its gradient finite
and leave every forward value as it was: an exactly tangent sphere ray
keeps its root with the gradient cut (``_f32.sqrt_grad_safe``), and the
tree walks run without autograd, their winner's t re-derived
straight-through from its gathered parameters (``_winner_t_diff``).
Any-hit verdicts are booleans and carry no gradient: ``any_hit`` runs
without autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._f32 import sqrt as _sqrt
from .._f32 import sqrt_grad_safe as _sqrt_grad_safe

BIG = float(np.float32(3.0e38))  # "no hit" distance


class Hit(NamedTuple):
    t: torch.Tensor           # (B,) BIG on a miss
    hit: torch.Tensor         # (B,) bool
    point: torch.Tensor       # (B,3)
    normal: torch.Tensor      # (B,3) front-face flipped
    front_face: torch.Tensor  # (B,) bool
    mat_id: torch.Tensor      # (B,) int64


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _col(t_max):
    """A per-lane (B,) bound as a (B,1) column; a scalar stays a scalar."""
    if isinstance(t_max, torch.Tensor) and t_max.ndim:
        return t_max[..., None]
    return t_max


def sphere_t(origin, direction, center, radius, t_min, t_max):
    """(B,Ns) hit distances, BIG where there is none: half-b quadratic,
    near root preferred, far root fallback."""
    oc = origin[..., None, :] - center
    a = _dot(direction, direction)[..., None]
    half_b = _dot(oc, direction[..., None, :])
    c = _dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    ok = disc >= 0.0
    # a tangent ray (disc == 0) keeps its root and loses its gradient
    sqrtd = _sqrt_grad_safe(torch.where(ok, disc, torch.ones_like(disc)))
    inv_a = 1.0 / a
    root0 = (-half_b - sqrtd) * inv_a
    root1 = (-half_b + sqrtd) * inv_a
    tm = _col(t_max)
    in0 = ok & (root0 >= t_min) & (root0 <= tm)
    in1 = ok & (root1 >= t_min) & (root1 <= tm)
    return torch.where(in0, root0, torch.where(in1, root1, BIG))


def triangle_t(origin, direction, v0, edge1, edge2, t_min, t_max):
    """(B,Nt) Moller-Trumbore hit distances, BIG where there is none."""
    d = direction[..., None, :]
    h = _cross(d, edge2)
    a = _dot(edge1, h)
    degenerate = torch.abs(a) < 1e-6
    f = 1.0 / torch.where(degenerate, torch.ones_like(a), a)
    s = origin[..., None, :] - v0
    u = f * _dot(s, h)
    q = _cross(s, edge1)
    v = f * _dot(d, q)
    t = f * _dot(edge2, q)
    tm = _col(t_max)
    valid = ((~degenerate) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t >= t_min) & (t <= tm))
    return torch.where(valid, t, BIG)


def triangle_blocked(origin, direction, v0, edge1, edge2, t_min, t_max):
    """(B,Nt) bool: division-free Moller-Trumbore any-hit.

    The triple-product identities det = -d.(e1 x e2) and
    s.(d x e2) = d.(e2 x s) turn every numerator into a dot product, and
    the range tests multiply through by |det| instead of dividing."""
    d = direction[..., None, :]
    s = origin[..., None, :] - v0
    n2 = _cross(edge1, edge2)
    c1 = _cross(edge2, s)
    q = _cross(s, edge1)
    det = -_dot(d, n2)
    sg = torch.where(det >= 0.0, 1.0, -1.0)
    ad = det * sg
    au = _dot(d, c1) * sg
    av = _dot(d, q) * sg
    at = _dot(edge2, q) * sg
    tm = _col(t_max)
    return ((ad >= 1e-6) & (au >= 0.0) & (av >= 0.0) & (au + av <= ad)
            & (at >= t_min * ad) & (at <= tm * ad))


def _slab(origin, direction, box_min, box_max):
    inv = 1.0 / torch.where(direction == 0.0,
                            torch.full_like(direction, 1e-30), direction)
    o = origin[..., None, :]
    iv = inv[..., None, :]
    t0 = (box_min - o) * iv
    t1 = (box_max - o) * iv
    near = torch.amax(torch.minimum(t0, t1), dim=-1)
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return near, far


def box_t(origin, direction, box_min, box_max, t_min, t_max):
    """(B,Nb) closest-hit distances of axis-aligned boxes: the slab
    interval's near crossing preferred, far fallback."""
    near, far = _slab(origin, direction, box_min, box_max)
    ok = near <= far
    tm = _col(t_max)
    in0 = ok & (near >= t_min) & (near <= tm)
    in1 = ok & (far >= t_min) & (far <= tm)
    return torch.where(in0, near, torch.where(in1, far, BIG))


def box_blocked(origin, direction, box_min, box_max, t_min, t_max):
    """(B,Nb) bool: a closed box blocks iff a slab crossing is in range."""
    near, far = _slab(origin, direction, box_min, box_max)
    tm = _col(t_max)
    return (near <= far) & (((near >= t_min) & (near <= tm))
                            | ((far >= t_min) & (far <= tm)))


def plane_t(origin, direction, point, normal, t_min, t_max):
    """(B,Np) infinite-plane hit distances, BIG where there is none."""
    denom = _dot(direction[..., None, :], normal)
    para = denom == 0.0
    t = (_dot(point - origin[..., None, :], normal)
         / torch.where(para, torch.ones_like(denom), denom))
    tm = _col(t_max)
    return torch.where((~para) & (t >= t_min) & (t <= tm), t, BIG)


def closest_hit(geom, origin, direction, t_min=1e-3, t_max=BIG,
                accel=None) -> Hit:
    """Closest hit over all primitives; first minimum wins in the order
    [spheres, triangles, planes, boxes]. Cube faces are hit as boxes.
    With ``accel`` (a bvh.FlatBVH over the spheres and triangles) the
    spheres and triangles are found by the tree walk instead."""
    if accel is not None:
        return _closest_hit_accel(geom, accel, origin, direction, t_min,
                                  t_max)
    ns = geom.sph_center.shape[0]
    nt = geom.tri_v0.shape[0]
    nt_t = geom.n_hit_tris
    B = origin.shape[:-1]
    cols = []
    if ns:
        cols.append(sphere_t(origin, direction, geom.sph_center,
                             geom.sph_radius, t_min, t_max))
    if nt:
        v0 = geom.tri_v0[:nt_t]
        tt = triangle_t(origin, direction, v0, geom.tri_v1[:nt_t] - v0,
                        geom.tri_v2[:nt_t] - v0, t_min, t_max)
        # cube-face columns stay BIG so plane/box ids keep their offsets
        cols.append(torch.nn.functional.pad(tt, (0, nt - nt_t), value=BIG))
    if geom.pl_point.shape[0]:
        cols.append(plane_t(origin, direction, geom.pl_point,
                            geom.pl_normal, t_min, t_max))
    if geom.box_min.shape[0]:
        cols.append(box_t(origin, direction, geom.box_min, geom.box_max,
                          t_min, t_max))
    if not cols:
        t = torch.full(B, BIG, dtype=origin.dtype, device=origin.device)
        idx = torch.zeros(B, dtype=torch.int64, device=origin.device)
    else:
        all_t = torch.cat(cols, dim=-1)
        # argmin keeps the first minimum: the reference's strict "<" scan
        idx = torch.argmin(all_t, dim=-1)
        t = torch.gather(all_t, -1, idx[..., None])[..., 0]
    return hit_from_tidx(geom, origin, direction, t, idx)


def _first_min(t):
    """(min over the last axis, index of its first occurrence)."""
    idx = torch.argmin(t, dim=-1)
    return torch.gather(t, -1, idx[..., None])[..., 0], idx


def _winner_t_diff(geom, origin, direction, t_walk, pid):
    """The walk winner's hit distance, straight-through differentiable
    (intersect.py:_winner_t_diff).

    The walk runs without autograd, so the winner's t is derived again
    from its gathered sphere or triangle by the closed-form expressions,
    and ``t_walk + (t_d - t_d.detach())`` keeps the walk's value bit for
    bit (the correction is exactly 0) while carrying the winner's
    gradient with respect to the ray and the geometry: the gradient of
    the brute-force select almost everywhere, since which primitive wins
    is piecewise constant. A sphere lane takes the root nearer the walk's
    t, chosen without gradient; lanes that the tree did not win keep t."""
    pid = pid.detach()
    tw = t_walk.detach()
    ns = geom.sph_center.shape[0]
    nt = geom.tri_v0.shape[0]
    t_s = t_t = None
    if ns:
        sp = torch.clamp(pid, 0, ns - 1)
        oc = origin - geom.sph_center[sp]
        r = geom.sph_radius[sp]
        a = _dot(direction, direction)
        half_b = _dot(oc, direction)
        disc = half_b * half_b - a * (_dot(oc, oc) - r * r)
        # a winner has disc >= 0; the guard keeps the gradient of the
        # clamped (non-winner) lanes finite
        sqrtd = _sqrt(torch.where(disc.detach() > 0.0, disc,
                                  torch.ones_like(disc)))
        r0 = (-half_b - sqrtd) / a
        r1 = (-half_b + sqrtd) / a
        near = (r0 - tw).abs().detach() <= (r1 - tw).abs().detach()
        t_s = torch.where(near, r0, r1)
    if nt:
        ti = torch.clamp(pid - ns, 0, nt - 1)
        v0 = geom.tri_v0[ti]
        e1 = geom.tri_v1[ti] - v0
        e2 = geom.tri_v2[ti] - v0
        h = _cross(direction, e2)
        det = _dot(e1, h)
        f = 1.0 / torch.where(det.detach().abs() >= 1e-6, det,
                              torch.ones_like(det))
        t_t = _dot(e2, _cross(origin - v0, e1)) * f
    if ns and nt:
        t_d = torch.where(pid < ns, t_s, t_t)
    else:
        t_d = t_s if ns else t_t
    in_tree = (pid >= 0) & (pid < ns + nt)
    t_d = torch.where(in_tree, t_d, torch.zeros_like(t_d))
    return t_walk + (t_d - t_d.detach())


def _closest_hit_accel(geom, accel, origin, direction, t_min, t_max) -> Hit:
    """Tree walk over spheres and triangles, brute force over planes and
    boxes, merged by nearest t (intersect.py:_closest_hit_accel).

    The boxes go first and their winning t seeds the walk, so subtrees
    behind a cube are culled. The walk takes a hit only when t < t_best,
    so a tree primitive at exactly the box's t loses to the box, and a
    plane must be strictly nearer than both to win: at exactly equal t
    the tie order is [boxes, tree, planes], not the brute-force
    [spheres, triangles, planes, boxes].

    The walk (which writes its tensors in place) runs on detached inputs
    without autograd; when autograd records the ray or the tree's
    geometry, the winner's t is made differentiable by
    ``_winner_t_diff``. Callers that move geometry drop the accel
    (``diff.split_params``): a stale tree can cull moved primitives."""
    from .. import bvh as bvh_mod
    ns = geom.sph_center.shape[0]
    nt = geom.tri_v0.shape[0]
    npl = geom.pl_point.shape[0]
    nb = geom.box_min.shape[0]
    tm_walk = torch.as_tensor(t_max, dtype=origin.dtype,
                              device=origin.device)
    if nb:
        t_box, b_idx = _first_min(box_t(origin, direction, geom.box_min,
                                        geom.box_max, t_min, t_max))
        tm_walk = torch.minimum(tm_walk, t_box)
    walk = (bvh_mod.traverse_closest_wide if bvh_mod.wide_walk(accel)
            else bvh_mod.traverse_closest)
    with torch.no_grad():
        t, pid = walk(accel, geom, origin.detach(), direction.detach(),
                      t_min, tm_walk.detach())
    if torch.is_grad_enabled() and any(x.requires_grad for x in (
            origin, direction, geom.sph_center, geom.sph_radius,
            geom.tri_v0, geom.tri_v1, geom.tri_v2)):
        t = _winner_t_diff(geom, origin, direction, t, pid)
    if nb:
        box_wins = t_box < t
        t = torch.where(box_wins, t_box, t)
        pid = torch.where(box_wins, ns + nt + npl + b_idx, pid)
    if npl:
        t_pl, pl_idx = _first_min(plane_t(origin, direction, geom.pl_point,
                                          geom.pl_normal, t_min, t_max))
        pl_wins = t_pl < t
        t = torch.where(pl_wins, t_pl, t)
        pid = torch.where(pl_wins, ns + nt + pl_idx, pid)
    # a miss keeps pid -1; hit_from_tidx reads only lanes with t < BIG
    return hit_from_tidx(geom, origin, direction, t, torch.clamp(pid, min=0))


def _interp_tri_normal(geom, ti, origin, direction, n_face):
    """Barycentric vertex-normal interpolation for the winning triangle
    (w*n0 + u*n1 + v*n2, w = 1-u-v, normalised). u and v are recomputed
    for the winner by the expressions of the hit test (f = 1/det), and
    the normal is scaled by 1/len, not divided by len: the two round
    differently, and the kernels use this form. A degenerate determinant
    keeps the face normal."""
    v0 = geom.tri_v0[ti]
    e1 = geom.tri_v1[ti] - v0
    e2 = geom.tri_v2[ti] - v0
    h = _cross(direction, e2)
    det = _dot(e1, h)
    good = torch.abs(det) >= 1e-6
    f = 1.0 / torch.where(good, det, torch.ones_like(det))
    s = origin - v0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(direction, q)
    vn = geom.tri_vn[ti]
    w = 1.0 - u - v
    n = (w[..., None] * vn[..., 0:3] + u[..., None] * vn[..., 3:6]
         + v[..., None] * vn[..., 6:9])
    ln = _sqrt(_dot(n, n))
    inv = 1.0 / torch.where(ln > 0.0, ln, torch.ones_like(ln))
    n = n * inv[..., None]
    return torch.where(good[..., None], n, n_face)


def hit_from_tidx(geom, origin, direction, t, idx) -> Hit:
    """The hit record from (t, winner index in [sph, tri, pln, box]); a
    triangle of a smooth-shaded scene (``geom.tri_vn``) takes its
    interpolated vertex normal."""
    ns = geom.sph_center.shape[0]
    nt = geom.tri_v0.shape[0]
    npl = geom.pl_point.shape[0]
    nbx = geom.box_min.shape[0]
    hit = t < BIG
    t_geo = torch.where(hit, t, torch.ones_like(t))
    point = origin + direction * t_geo[..., None]
    zeros3 = torch.zeros_like(point)
    zeros_i = torch.zeros_like(idx)

    is_sphere = idx < ns
    is_box = idx >= (ns + nt + npl)
    is_plane = (idx >= (ns + nt)) & ~is_box
    if ns:
        si = torch.clamp(idx, max=ns - 1)
        n_sph = (point - geom.sph_center[si]) / geom.sph_radius[si][..., None]
        m_sph = geom.sph_mat[si].to(torch.int64)
    else:
        n_sph, m_sph = zeros3, zeros_i
    if nt:
        ti = torch.clamp(idx - ns, 0, nt - 1)
        n_tri = geom.tri_normal[ti]
        m_tri = geom.tri_mat[ti].to(torch.int64)
        if geom.tri_vn is not None:
            n_tri = _interp_tri_normal(geom, ti, origin, direction, n_tri)
    else:
        n_tri, m_tri = zeros3, zeros_i
    if npl:
        pi = torch.clamp(idx - ns - nt, 0, npl - 1)
        n_pl = geom.pl_normal[pi]
        m_pl = geom.pl_mat[pi].to(torch.int64)
    else:
        n_pl, m_pl = zeros3, zeros_i
    if nbx:
        # Point-based box normal, NEGATED: the reference winds every cube
        # face inward, so exterior hits carry front_face=False (which
        # steers the dielectric eta). Ties resolve x < y < z.
        bi = torch.clamp(idx - ns - nt - npl, 0, nbx - 1)
        lo, hi = geom.box_min[bi], geom.box_max[bi]
        ctr = (lo + hi) * 0.5
        half = torch.clamp((hi - lo) * 0.5, min=1e-30)
        q = (point - ctr) / half
        ax = torch.argmax(torch.abs(q), dim=-1, keepdim=True)
        one_hot = torch.zeros_like(q).scatter_(-1, ax, 1.0)
        n_box = -(one_hot * torch.sign(torch.gather(q, -1, ax)))
        m_box = geom.box_mat[bi].to(torch.int64)
    else:
        n_box, m_box = zeros3, zeros_i

    outward = torch.where(
        is_sphere[..., None], n_sph, torch.where(
            is_box[..., None], n_box,
            torch.where(is_plane[..., None], n_pl, n_tri)))
    mat_id = torch.where(is_sphere, m_sph, torch.where(
        is_box, m_box, torch.where(is_plane, m_pl, m_tri)))
    front_face = _dot(direction, outward) < 0.0
    normal = torch.where(front_face[..., None], outward, -outward)
    return Hit(t=t, hit=hit, point=point, normal=normal,
               front_face=front_face, mat_id=mat_id)


def _any(hit, occluders, first):
    """(B,) bool: any hit (B,N), of the occluders ``first``..``first+N`` of
    the per-lane mask ``occluders`` (B,M) when one is given."""
    if occluders is not None:
        hit = hit & occluders[:, first:first + hit.shape[-1]]
    return torch.any(hit, dim=-1)


def _any_sphere_triangle(geom, origin, direction, t_min, t_max, exact,
                         occluders=None):
    """(B,) bool: brute-force occlusion by the spheres and the hit
    triangles."""
    blocked = torch.zeros(origin.shape[:-1], dtype=torch.bool,
                          device=origin.device)
    ns = geom.sph_center.shape[0]
    if ns:
        t = sphere_t(origin, direction, geom.sph_center, geom.sph_radius,
                     t_min, t_max)
        blocked |= _any(t < BIG, occluders, 0)
    nt = geom.n_hit_tris
    if nt:
        v0 = geom.tri_v0[:nt]
        e1 = geom.tri_v1[:nt] - v0
        e2 = geom.tri_v2[:nt] - v0
        if exact:
            hit = triangle_t(origin, direction, v0, e1, e2, t_min,
                             t_max) < BIG
        else:
            hit = triangle_blocked(origin, direction, v0, e1, e2, t_min,
                                   t_max)
        blocked |= _any(hit, occluders, ns)
    return blocked


@torch.no_grad()
def any_hit(geom, origin, direction, t_min, t_max, accel=None, exact=False,
            occluders=None):
    """(B,) bool: does any primitive intersect with t in [t_min, t_max]?

    ``t_max`` may be per lane. ``exact=True`` tests triangles with the
    closest-hit expressions (``triangle_t``) instead of the division-free
    form, whose verdicts can flip at 1-2 ulp boundaries: a primary-hit
    mask must never exclude a lane the closest hit would accept. With
    ``accel`` the spheres and triangles are tested by the early-exit tree
    walk (bvh.traverse_any); planes and boxes stay brute force.
    ``occluders`` (B, spheres + hit triangles + boxes + planes) bool, in
    that order, brute force only: each lane tests only its flagged
    primitives (K1-guard's flags). The verdicts carry no gradient, so
    autograd records nothing here.
    """
    if accel is not None:
        if occluders is not None:
            raise ValueError("per-lane occluders are brute force only")
        from .. import bvh as bvh_mod
        blocked = bvh_mod.traverse_any(accel, geom, origin, direction, t_min,
                                       t_max, exact=exact)
    else:
        blocked = _any_sphere_triangle(geom, origin, direction, t_min, t_max,
                                       exact, occluders)
    first = geom.sph_center.shape[0] + geom.n_hit_tris
    if geom.box_min.shape[0]:
        blocked |= _any(box_blocked(origin, direction, geom.box_min,
                                    geom.box_max, t_min, t_max), occluders,
                        first)
    if geom.pl_point.shape[0]:
        t = plane_t(origin, direction, geom.pl_point, geom.pl_normal, t_min,
                    t_max)
        blocked |= _any(t < BIG, occluders, first + geom.box_min.shape[0])
    return blocked
