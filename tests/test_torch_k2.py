"""K2's plain versions on the CPU: its table, its tests over the table,
its early exit, and the mask on a given camera row.

* ``k2_table_plain``: a leaf row a primitive, in primitive order (the
  spheres, then every triangle's bounding sphere, cube faces included),
  holding ``_bsphere_table``'s sphere and the terms that ``_bs_hit``
  computes before it looks at the pixel, bit for bit.
* The table-based test (``_k2_hits``, what ``pixel_mask_plain`` runs in
  unroll and loop modes) equals the per-pixel ``_bs_hit`` form over
  ``_bsphere_table`` bit for bit, also when it goes over the pixels in
  small steps.
* The early-exit form (``k2_walk_plain``: each pixel stops at its first
  hit, as the kernel's loop does) equals the all-ors form, and its leaf
  tests are those that the first hits leave.
* ``pixel_mask_plain(cam=_mask_camera(...))`` equals ``pixel_mask_plain()``.

Scenes: the bench spheres (assets/sphere_reflections_light.json, camera
mirrored to +Z), textured_mirror_demo (spheres, cubes, a plane) and the
``mesh_smooth_icosphere`` golden without its BVH (81 primitives, loop
mode), each on the go camera and on its look-at camera, pinhole and with
two thin lenses (L=0.1, F=10 and L=0.25, F=5), at 40x30. The mask's
agreement with the JAX package is held by test_torch_megakernel.py and
test_torch_dof.py; this file calls no Pallas kernel.
"""

import json
import os

import pytest
import torch

from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench.suite import golden_scene_dict
from raytrace_tpu_torch.ops import megakernel as tmk

W, H = 40, 30
ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
SCENES = ("bench", "textured_mirror_demo", "icosphere")
CAMERAS = {"go": True, "lookat": False}
LENSES = {"pinhole": None, "L0.1-F10": (0.1, 10.0), "L0.25-F5": (0.25, 5.0)}


def build(name):
    if name == "bench":
        with open(os.path.join(ASSETS, "sphere_reflections_light.json")) as f:
            d = json.load(f)
        d["camera"]["position"][2] = -d["camera"]["position"][2]
        s = tscene.from_dict(d, device="cpu")[0]
    elif name == "icosphere":
        s = tscene.from_dict(golden_scene_dict("mesh_smooth_icosphere")[0],
                             device="cpu", build_accel=False)[0]
    else:
        s = tscene.load(os.path.join(ASSETS, f"{name}.json"),
                        device="cpu")[0]
    assert tmk._kernel_mode(s) == ("loop" if name == "icosphere"
                                   else "unroll")
    return s


@pytest.fixture(scope="module")
def scenes():
    return {n: build(n) for n in SCENES}


def cfg_of(lens):
    if LENSES[lens] is None:
        return ttrace.TraceConfig()
    L, F = LENSES[lens]
    return ttrace.TraceConfig(depth_of_field=True, dof_lens_radius=L,
                              dof_focus_distance=F)


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(
        torch.int32), b.contiguous().view(torch.int32))


def setup(scenes, name, camera, lens):
    s, cfg, go = scenes[name], cfg_of(lens), CAMERAS[camera]
    cam = tmk._mask_camera(s, W, H, cfg, go)
    rows = tmk.k2_table_plain(s, cam, cfg).reshape(-1, tmk.MASK_LEAF)
    return s, cfg, go, cam, rows


CASES = [(n, c, l) for n in SCENES for c in CAMERAS for l in LENSES]
IDS = ["-".join(c) for c in CASES]


@pytest.mark.parametrize("name,camera,lens", CASES, ids=IDS)
def test_k2_table_equals_bsphere_terms(scenes, name, camera, lens):
    s, cfg, _, cam, rows = setup(scenes, name, camera, lens)
    bs = tmk._bsphere_table(s)
    g = s.geometry
    assert rows.shape == (g.sph_center.shape[0] + g.tri_v0.shape[0],
                          tmk.MASK_LEAF) == (bs.shape[0], tmk.MASK_LEAF)
    assert same_bits(bs[:g.sph_center.shape[0], :3], g.sph_center)
    assert same_bits(bs[:g.sph_center.shape[0], 3], g.sph_radius)
    # _bs_hit's terms, in its operations
    oc = bs[:, :3] - cam[0:3]
    ocx, ocy, ocz = oc[:, 0], oc[:, 1], oc[:, 2]
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    r = bs[:, 3]
    dist = torch.sqrt(oc2.to(torch.float64)).to(torch.float32)
    for col, want in enumerate((ocx, ocy, ocz, oc2, dist, r)):
        assert same_bits(rows[:, col], want), col
    base = r + (dist + r) * cam[12]
    if cfg.depth_of_field:
        assert same_bits(rows[:, 6], base)
        assert not rows[:, 7].any()
    else:
        assert same_bits(rows[:, 6], base + 1e-3)
        assert same_bits(rows[:, 7], (base + 1e-3) * (base + 1e-3))


@pytest.mark.parametrize("name,camera,lens", CASES, ids=IDS)
def test_k2_table_hits_equal_bs_hit(scenes, name, camera, lens,
                                    monkeypatch):
    """Every pixel: the tests over the table give the per-pixel
    bounding-sphere tests' or, also in steps of a few pixels."""
    s, cfg, _, cam, rows = setup(scenes, name, camera, lens)
    d, inv_a, sqa, inv_sq = tmk._center_rays(cam, W, H, s.device)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    want = torch.any(tmk._bs_hit(cam[0:3], dx, dy, dz, inv_a, sqa, inv_sq,
                                 cam, tmk._bsphere_table(s)[None]), dim=-1)
    got = tmk._k2_hits(rows, d, inv_a, sqa, inv_sq, cam, cfg.depth_of_field)
    assert want.any()
    assert torch.equal(got, want)
    monkeypatch.setattr(tmk, "K2_PLAIN_PAIRS", 7 * rows.shape[0])
    assert torch.equal(tmk._k2_hits(rows, d, inv_a, sqa, inv_sq, cam,
                                    cfg.depth_of_field), want)


@pytest.mark.parametrize("name,camera,lens", CASES, ids=IDS)
def test_k2_early_exit_equals_all_ors(scenes, name, camera, lens):
    s, cfg, _, cam, rows = setup(scenes, name, camera, lens)
    d, inv_a, sqa, inv_sq = tmk._center_rays(cam, W, H, s.device)
    dof = cfg.depth_of_field
    all_ors = tmk._k2_hits(rows, d, inv_a, sqa, inv_sq, cam, dof)
    work = [0, 0]
    early = tmk.k2_walk_plain(rows, d, inv_a, sqa, inv_sq, cam, dof,
                              work=work)
    assert torch.equal(early, all_ors)
    # the leaf tests: a hit pixel up to its first hit, a missed one all
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    each = tmk._leaf_hit(rows[None], dx, dy, dz, inv_a, sqa, inv_sq, cam,
                         dof)
    n = rows.shape[0]
    first = torch.where(each.any(-1), each.int().argmax(-1) + 1, n)
    assert work == [0, int(first.sum())]
    assert work[1] < n * W * H or not all_ors.any()
    # a pixel given as hit (the planes) tests nothing
    pre = torch.zeros_like(all_ors)
    pre[::3] = True
    work = [0, 0]
    got = tmk.k2_walk_plain(rows, d, inv_a, sqa, inv_sq, cam, dof, pre, work)
    assert torch.equal(got, all_ors | pre)
    assert work[1] == int(first[~pre].sum())


@pytest.mark.parametrize("name,camera,lens", CASES, ids=IDS)
def test_pixel_mask_plain_on_a_camera_row(scenes, name, camera, lens):
    """pixel_mask_plain on a given camera row (the kernels' own, on the
    card) equals it on _mask_camera's; the early-exit form (``work``)
    gives the same mask."""
    s, cfg, go, cam, _ = setup(scenes, name, camera, lens)
    kw = dict(width=W, height=H, cfg=cfg, go_camera=go)
    want = tmk.pixel_mask_plain(s, **kw)
    assert torch.equal(tmk.pixel_mask_plain(s, cam=cam, **kw), want)
    work = [0, 0]
    assert torch.equal(tmk.pixel_mask_plain(s, work=work, **kw), want)
    assert work[0] == 0 and work[1] > 0
