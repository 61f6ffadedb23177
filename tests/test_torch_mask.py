"""The mask table of K6 and K6-stream (the pre-pass's plain version,
``megakernel.mask_table_plain``) and the walk over it, on the CPU.

* Node rows: the mask table's node rows hold ``_mask_tree``'s grown slabs
  and the tree's skip, first and count, bit for bit, in the layout
  [min.xyz, skip, max.xyz, first, count, 0, 0, 0] that
  ``csrc/pixel_mask.cu`` reads; a stream-mode table holds nothing else.
* Leaf rows (bvh mode): one a leaf slot, in slot order, holding the
  bounding sphere of ``_bsphere_table``'s row of prim_index[slot] and the
  terms that ``_bs_hit`` computes before it looks at the pixel, bit for
  bit; and the leaf test over a row (``_leaf_hit``) equals ``_bs_hit``
  over the bounding sphere for every (pixel, slot) pair.
* The walk over the table equals the walk of the per-pixel form (node
  slabs of ``_mask_tree``, ``_bs_hit`` over ``_bsphere_table`` through
  prim_index at each boxed leaf), mask and work counters.

Scenes: ring-300 (bvh mode), two subdivision-2 icospheres over a plane
(641 primitives, bvh mode, look-at camera) and a grid of 125 spheres over
a plane forced into stream mode (MAX_BVH_KERNEL_PRIMS lowered in both of
the port's modules before the build). Each runs pinhole, with two
thin-lens settings (L=0.1, F=10 and L=0.25, F=5) and with L=0.25, F=5
under a camera up of length 2, at 40x30. The mask's own agreement with
the JAX package is held by test_torch_bvh.py, test_torch_stream.py and
test_torch_dof.py, which call pixel_mask_plain; this file calls no
Pallas kernel.
"""

import dataclasses

import pytest
import torch

from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench import suite
from raytrace_tpu_torch.ops import megakernel as tmk

W, H = 40, 30
SCENES = ("ring300", "ico2", "grid-stream")
LEAF_SCENES = ("ring300", "ico2")
# (lens radius, focus distance, camera up length); None: pinhole
LENSES = {"pinhole": None, "L0.1-F10": (0.1, 10.0, 1.0),
          "L0.25-F5": (0.25, 5.0, 1.0), "L0.25-F5-up2": (0.25, 5.0, 2.0)}


@pytest.fixture(scope="module")
def obj_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("obj"))


def build(name, lens, obj_dir, monkeypatch):
    """(scene, trace settings, go camera)."""
    go = True
    if name == "ring300":
        d = suite.ring_scene_dict(300)
    elif name == "ico2":
        d = suite.mesh_scene_dict(obj_dir, subdiv=2)
        go = False
    else:
        monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 64)
        monkeypatch.setattr(tscene, "MAX_BVH_KERNEL_PRIMS", 64)
        d = suite.grid_scene_dict(side=5)
    s = tscene.from_dict(d, device="cpu")[0]
    assert tmk._kernel_mode(s) == ("stream" if name == "grid-stream"
                                   else "bvh")
    spec = LENSES[lens]
    if spec is None:
        return s, ttrace.TraceConfig(), go
    L, F, up = spec
    if up != 1.0:
        s = dataclasses.replace(s, camera=dataclasses.replace(
            s.camera, up=s.camera.up * up))
    return s, ttrace.TraceConfig(depth_of_field=True, dof_lens_radius=L,
                                 dof_focus_distance=F), go


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(
        torch.int32), b.contiguous().view(torch.int32))


def table_of(s, cfg, go):
    cam = tmk._mask_camera(s, W, H, cfg, go)
    return cam, tmk.mask_table_plain(s, cam, cfg)


@pytest.mark.parametrize("lens", list(LENSES))
@pytest.mark.parametrize("name", SCENES)
def test_node_rows_equal_mask_tree(name, lens, obj_dir, monkeypatch):
    s, cfg, go = build(name, lens, obj_dir, monkeypatch)
    cam, tab = table_of(s, cfg, go)
    nodes, _ = tmk._mask_tree(s, cam, cfg)
    acc = s.accel
    n = acc.n_nodes
    rows = tab[:tmk.MASK_NODE * n].reshape(n, tmk.MASK_NODE)
    assert same_bits(rows[:, 0:3], nodes[:, 0:3])
    assert same_bits(rows[:, 4:7], nodes[:, 3:6])
    for col, ints in ((3, acc.node_skip), (7, acc.node_first),
                      (8, acc.node_count)):
        assert torch.equal(rows[:, col], ints.to(torch.float32))
    assert not rows[:, 9:].any()
    # the slabs grew: every node row holds its box
    assert bool((rows[:, 0:3] < acc.node_min).all()
                and (rows[:, 4:7] > acc.node_max).all())
    n_leaf = 0 if name == "grid-stream" else acc.prim_index.shape[0]
    assert tab.numel() == tmk.MASK_NODE * n + tmk.MASK_LEAF * n_leaf


@pytest.mark.parametrize("lens", list(LENSES))
@pytest.mark.parametrize("name", LEAF_SCENES)
def test_leaf_rows_equal_bsphere_terms(name, lens, obj_dir, monkeypatch):
    s, cfg, go = build(name, lens, obj_dir, monkeypatch)
    cam, tab = table_of(s, cfg, go)
    n = s.accel.n_nodes
    leaves = tab[tmk.MASK_NODE * n:].reshape(-1, tmk.MASK_LEAF)
    bs = tmk._bsphere_table(s)[s.accel.prim_index.to(torch.int64)]
    assert leaves.shape[0] == bs.shape[0]
    # _bs_hit's terms, in its operations
    k = cam[12]
    oc = bs[:, :3] - cam[0:3]
    ocx, ocy, ocz = oc[:, 0], oc[:, 1], oc[:, 2]
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    r = bs[:, 3]
    dist = torch.sqrt(oc2.to(torch.float64)).to(torch.float32)
    for col, want in enumerate((ocx, ocy, ocz, oc2, dist, r)):
        assert same_bits(leaves[:, col], want), col
    if cfg.depth_of_field:
        assert same_bits(leaves[:, 6], r + (dist + r) * k)
        assert not leaves[:, 7].any()
    else:
        R = r + (dist + r) * k + torch.zeros_like(r) + 1e-3
        assert same_bits(leaves[:, 6], R)
        assert same_bits(leaves[:, 7], R * R)


@pytest.mark.parametrize("lens", list(LENSES))
@pytest.mark.parametrize("name", LEAF_SCENES)
def test_leaf_hit_equals_bs_hit(name, lens, obj_dir, monkeypatch):
    """Every (pixel, slot) pair: the test over the leaf row gives the
    per-pixel bounding-sphere test's verdict."""
    s, cfg, go = build(name, lens, obj_dir, monkeypatch)
    cam, tab = table_of(s, cfg, go)
    leaves = tab[tmk.MASK_NODE * s.accel.n_nodes:].reshape(-1, tmk.MASK_LEAF)
    bs = tmk._bsphere_table(s)[s.accel.prim_index.to(torch.int64)]
    d, inv_a, sqa, inv_sq = tmk._center_rays(cam, W, H, s.device)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    got = tmk._leaf_hit(leaves[None], dx, dy, dz, inv_a, sqa, inv_sq, cam,
                        cfg.depth_of_field)
    want = tmk._bs_hit(cam[0:3], dx, dy, dz, inv_a, sqa, inv_sq, cam,
                       bs[None])
    assert got.shape == (W * H, bs.shape[0])
    assert want.any() and (~want).any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("lens", list(LENSES))
@pytest.mark.parametrize("name", SCENES)
def test_table_walk_equals_per_pixel_walk(name, lens, obj_dir, monkeypatch):
    """The walk over the mask table against the walk of the per-pixel
    form: the same mask and the same work (slab tests, leaf tests)."""
    s, cfg, go = build(name, lens, obj_dir, monkeypatch)
    cam, tab = table_of(s, cfg, go)
    work = [0, 0]
    got = tmk.mask_walk_plain(s, cam, tab, width=W, height=H, cfg=cfg,
                              work=work)
    nodes, pidx = tmk._mask_tree(s, cam, cfg)
    d, inv_a, sqa, inv_sq = tmk._center_rays(cam, W, H, s.device)
    o = cam[0:3]
    leaf_hits = None
    if name != "grid-stream":
        bs = tmk._bsphere_table(s)
        last = pidx.shape[0] - 1

        def leaf_hits(slot, px):
            rows = bs[pidx[torch.clamp(slot, max=last)].to(torch.int64)]
            dd = d[px]
            return tmk._bs_hit(o, dd[:, 0:1], dd[:, 1:2], dd[:, 2:3],
                               inv_a[px], sqa[px], inv_sq[px], cam, rows)

    ref_work = [0, 0]
    want = tmk._mask_walk(o, d, tmk._node_rows(nodes), s.accel.leaf_size,
                          leaf_hits, ref_work)
    assert want.any() and (~want).any() or name == "ring300"
    assert torch.equal(got, want)
    assert work == ref_work
    # the mask is the walk or the planes
    full = tmk.pixel_mask_plain(s, width=W, height=H, cfg=cfg, go_camera=go)
    assert not (got & ~full).any()
