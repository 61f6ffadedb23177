"""K1-guard's plain version (raytrace_tpu_torch.ops.megakernel:
soft_guard_mask, soft_factor_guarded, shadow_factor_guarded).

* Soundness, a seeded property test: 2,400 random cases per occluder kind
  (sphere, triangle, box, plane), a third of them drawn at random, a third
  grazing the soft-shadow cone's edge and a third in near contact (the
  shading point within 1e-3 of the occluder, or the light just past it).
  Each case is tested with 16 cone directions, normalize(ld + 0.1 b):
  eight with |b| <= 1 drawn uniformly and eight on the cone's edge
  (|b| = 1), pointed at the occluder. Wherever the guard is False, none
  of the directions may be blocked by the occluder's own sample test
  (intersect.sphere_t, triangle_blocked, box_blocked, plane_t in
  [1e-3, dist]): exact, the guard's whole claim.
* Bit for bit on scenes: the plain engine with the guarded soft-shadow
  loop (shade.shadow_factor swapped for shadow_factor_guarded) gives the
  same radiance, bit for bit, as the unguarded engine on every lane of a
  40x30 frame (1 spp, depth 3, 8 soft-shadow rays) of the three unroll
  goldens (spheres, boxes and a plane, a prism's triangles) and the bench
  scene; and at the first hit of every lane the guarded and unguarded
  soft factors are equal (torch.equal).

K1 on the card runs the same guard; chip_smoke.py holds it to these plain
versions and to K1 unguarded at error 0.
"""

import json
import os

import numpy as np
import pytest
import torch

import make_goldens
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.ops import intersect as tisect
from raytrace_tpu_torch.ops import megakernel as tmk
from raytrace_tpu_torch.ops import shade as tshade
from test_torch_scene import one_torch_thread  # noqa: F401

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
N_CASES = 2400
N_DIRS = 16
CHUNK = 200


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _perp(v, rng):
    """A random unit vector perpendicular to each row of v."""
    w = _unit(np.cross(v, rng.normal(size=v.shape)))
    return w


def _cases(kind, seed):
    """(p (B,3), ld (B,3), dist (B,), a point the occluder sits at (B,3),
    a scale (B,)) for N_CASES cases of three families."""
    rng = np.random.default_rng(seed)
    n = N_CASES
    p = rng.uniform(-5, 5, (n, 3))
    ld = _unit(rng.normal(size=(n, 3)))
    fam = np.arange(n) % 3
    t0 = np.exp(rng.uniform(np.log(0.01), np.log(20.0), n))
    # direction to the occluder: random (0), at the cone's edge (1, the
    # asin(0.1) angle, within +-1%), near the ray (2)
    ang = np.where(fam == 1, np.arcsin(0.1) * rng.uniform(0.99, 1.01, n),
                   np.where(fam == 0, rng.uniform(0, 0.5, n),
                            rng.uniform(0, 0.12, n)))
    side = _perp(ld, rng)
    to = _unit(np.cos(ang)[:, None] * ld + np.sin(ang)[:, None] * side)
    at = p + t0[:, None] * to
    scale = np.exp(rng.uniform(np.log(0.01), np.log(3.0), n))
    # the light: beyond the occluder, just past it (near contact), or short
    # of it
    dist = np.where(fam == 2, t0 * rng.uniform(0.98, 1.02, n),
                    t0 * np.exp(rng.uniform(-1.0, 1.5, n)))
    return p, ld, dist, at, scale, fam, rng


def _occluder(kind, seed):
    """One occluder per case, in the leading columns of pack_tables, and
    the cases."""
    p, ld, dist, at, scale, fam, rng = _cases(kind, seed)
    n = p.shape[0]
    if kind == "sphere":
        r = scale.copy()
        # near contact: p on the surface, within 1e-3 either side
        near = fam == 2
        dirn = _unit(rng.normal(size=(n, 3)))
        c = np.where(near[:, None],
                     p + dirn * (r + rng.uniform(-1e-3, 1e-3, n))[:, None],
                     at + _perp(ld, rng) * (r * rng.uniform(0.9, 1.1, n)
                                            )[:, None] * (fam == 1)[:, None])
        tab = np.concatenate([c, r[:, None]], 1)
    elif kind == "triangle":
        v0 = at + rng.normal(size=(n, 3)) * scale[:, None]
        e1 = rng.normal(size=(n, 3)) * scale[:, None]
        e2 = rng.normal(size=(n, 3)) * scale[:, None]
        near = fam == 2
        # near contact: p within 1e-3 of the triangle's plane, inside it
        nrm = _unit(np.cross(e1, e2))
        inside = v0 + 0.3 * e1 + 0.3 * e2
        p = np.where(near[:, None],
                     inside + nrm * rng.uniform(-1e-3, 1e-3, n)[:, None], p)
        tab = np.concatenate([v0, e1, e2], 1)
    elif kind == "box":
        half = np.abs(rng.normal(size=(n, 3))) * scale[:, None] + 1e-3
        ctr = at.copy()
        near = fam == 2
        # near contact: p within 1e-3 of a face
        ax = rng.integers(0, 3, n)
        sgn = rng.choice([-1.0, 1.0], n)
        q = ctr + rng.uniform(-1, 1, (n, 3)) * half
        q[np.arange(n), ax] = (ctr[np.arange(n), ax] + sgn
                               * (half[np.arange(n), ax]
                                  + rng.uniform(-1e-3, 1e-3, n)))
        p = np.where(near[:, None], q, p)
        tab = np.concatenate([ctr - half, ctr + half], 1)
    else:  # plane
        nrm = _unit(rng.normal(size=(n, 3)))
        # grazing: a normal almost perpendicular to the light direction
        graze = fam == 1
        nrm = np.where(graze[:, None],
                       _unit(_perp(ld, rng) + 0.05 * rng.normal(size=(n, 3))
                             * rng.uniform(0, 1, n)[:, None]), nrm)
        # the plane at a height h from p along its normal, on the light's
        # side: h around dist (its guard's bound), within 1e-4 of it in
        # near contact
        h = np.where(fam == 2, dist * rng.uniform(1 - 1e-4, 1 + 1e-4, n),
                     dist * rng.uniform(0.5, 1.5, n))
        sgn = np.where((nrm * ld).sum(-1) >= 0, 1.0, -1.0)
        pt = p + nrm * (sgn * h)[:, None]
        tab = np.concatenate([pt, nrm], 1)
    return p, ld, dist, tab


def _dirs(ld, p, target, rng):
    """N_DIRS cone directions per case: uniform in the unit ball, and on
    the cone's edge toward the occluder."""
    n = ld.shape[0]
    out = []
    for s in range(N_DIRS):
        if s < N_DIRS // 2:
            b = _unit(rng.normal(size=(n, 3))) * rng.uniform(
                0, 1, n)[:, None] ** (1 / 3)
        else:
            to = _unit(target - p)
            b = _unit(to - ld + rng.normal(size=(n, 3)) * 0.02 * s)
        out.append(_unit(ld + 0.1 * b))
    return out


@pytest.mark.parametrize("kind", ["sphere", "triangle", "box", "plane"])
def test_guard_is_conservative(kind):
    seed = {"sphere": 11, "triangle": 12, "box": 13, "plane": 14}[kind]
    p, ld, dist, tab = _occluder(kind, seed)
    rng = np.random.default_rng(seed + 100)
    target = tab[:, 0:3] if kind != "box" else (tab[:, 0:3]
                                                + tab[:, 3:6]) / 2
    if kind == "triangle":
        target = tab[:, 0:3] + (tab[:, 3:6] + tab[:, 6:9]) / 3
    dirs = _dirs(ld, p, target, rng)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    empty = lambda c: torch.zeros((0, c))
    n_false = n_blocked = 0
    for i0 in range(0, p.shape[0], CHUNK):
        sl = slice(i0, i0 + CHUNK)
        tp, tld, tdist = f(p[sl]), f(ld[sl]), f(dist[sl])
        # ld must be unit in float32 as the kernel's normalize3 makes it
        tld = tld / torch.sqrt((tld * tld).sum(-1, keepdim=True))
        occ = f(tab[sl])
        tables = {"sph": empty(4), "tri": empty(9), "box": empty(6),
                  "pln": empty(6)}
        tables[{"sphere": "sph", "triangle": "tri", "box": "box",
                "plane": "pln"}[kind]] = occ
        need = torch.ones(tp.shape[0], dtype=torch.bool)
        can = tmk.soft_guard_mask(tables, tp, tld, tdist, need)
        can = torch.diagonal(can)                 # case i, occluder i
        for dd in dirs:
            sd = f(dd[sl])
            if kind == "sphere":
                hit = tisect.sphere_t(tp, sd, occ[:, 0:3], occ[:, 3], 1e-3,
                                      tdist) < tisect.BIG
            elif kind == "triangle":
                hit = tisect.triangle_blocked(tp, sd, occ[:, 0:3],
                                              occ[:, 3:6], occ[:, 6:9],
                                              1e-3, tdist)
            elif kind == "box":
                hit = tisect.box_blocked(tp, sd, occ[:, 0:3], occ[:, 3:6],
                                         1e-3, tdist)
            else:
                hit = tisect.plane_t(tp, sd, occ[:, 0:3], occ[:, 3:6],
                                     1e-3, tdist) < tisect.BIG
            hit = torch.diagonal(hit)
            n_blocked += int(hit.sum())
            bad = hit & ~can
            assert not bad.any(), (
                f"{kind}: the guard is False but a cone ray is blocked in "
                f"case {i0 + int(bad.nonzero()[0, 0])}")
        n_false += int((~can).sum())
    # both outcomes occur, so the cases exercise the guard
    assert n_false > 0.1 * p.shape[0] and n_blocked > 0.05 * p.shape[0]


def golden_dict(name):
    return {n: d for n, d, _ in make_goldens.scenes()}[name]


def bench_dict():
    with open(os.path.join(ASSETS, "sphere_reflections_light.json")) as f:
        d = json.load(f)
    d["camera"]["position"][2] = -d["camera"]["position"][2]
    return d


@pytest.mark.parametrize("name", ["spheres_metal_glass",
                                  "cubes_dielectric_plane",
                                  "prism_perfectmirror", "bench"])
def test_guarded_soft_loop_is_bit_identical(name, monkeypatch):
    d = bench_dict() if name == "bench" else golden_dict(name)
    ts = tscene.from_dict(d, device="cpu")[0]
    assert tmk._kernel_mode(ts) == "unroll"
    W, H = 40, 30
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=8)
    pix = torch.arange(W * H)
    samp = torch.zeros_like(pix)
    o, dd = trender._lane_rays(ts, pix, samp, width=W, height=H, cfg=cfg,
                               go_camera=True)
    o = o.contiguous()
    # first hits: guarded and unguarded soft factors, light by light
    g = ts.geometry
    hit = tisect.closest_hit(g, o, dd)
    keep = hit.hit.nonzero()[:, 0]
    assert keep.numel() > 10     # the bench frame: 2% of the pixels hit
    pt = hit.point[keep]
    flagged = total = 0
    for li in range(ts.lights.position.shape[0]):
        to_l = ts.lights.position[li] - pt
        dist = torch.sqrt((to_l * to_l).sum(-1).double()).float()
        ld = tshade._normalize(to_l)
        kw = dict(soft_shadows=True, shadow_samples=8, seed=0)
        want = tshade.shadow_factor(g, pt, dist, ld, pix[keep], samp[keep],
                                    0, li, **kw)
        got = tmk.shadow_factor_guarded(g, pt, dist, ld, pix[keep],
                                        samp[keep], 0, li, **kw)
        assert torch.equal(got, want)
        can = tmk.soft_guard_mask(tmk.occluder_tables(g), pt, ld, dist,
                                  torch.ones_like(dist, dtype=torch.bool))
        flagged += int(can.sum())
        total += can.numel()
    # the guard skips (lane, light, occluder) triples on every scene
    assert flagged < total
    # every lane of the frame through the whole (depth 3) trace
    want = ttrace.trace(ts, o, dd, pix, samp, cfg)
    monkeypatch.setattr(tshade, "shadow_factor", tmk.shadow_factor_guarded)
    got = ttrace.trace(ts, o, dd, pix, samp, cfg)
    assert torch.equal(got, want)
    assert (want.sum(-1) > 0).sum() >= keep.numel()
