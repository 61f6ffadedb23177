"""K7's brute-force policy on the CPU: K1-guard past 96 occluders, and the
host side of the persistent launch of K1 and K7.

* Bit for bit: on loop-mode scenes (past the unroll limit, no BVH) - the
  mesh_smooth_icosphere golden without its BVH (80 smooth triangles and a
  plane), a ring of 300 spheres (301 occluders: four chunks of K1-guard's
  96) and the mixed scene without its BVH (91 spheres, 8 hit triangles, 2
  boxes and a plane: a chunk that crosses the occluder kinds) - the
  guarded soft factor (megakernel.shadow_factor_guarded, the plain version
  of K7's guard as of K1's) equals the unguarded shade.shadow_factor at the
  first hit of every lane, light by light (torch.equal), the guard skips
  some (lane, light, occluder) triples, and the whole plain engine with the
  guarded soft loop gives the unguarded radiance bit for bit.
* Against the JAX engine: the plain engine with the guarded soft loop on
  ring-300 without a BVH (the JAX package's loop mode, which runs
  unguarded) lane for lane against raytrace_tpu.trace within 1e-5, as
  tests/test_torch_trace.py holds the unguarded engine.
* The host side of the launch: K7's shared-memory budget (LOOP_SMEM_BYTES,
  K3+K4's 232,448 bytes), the tables that trace_tables reports in or out
  of it, and the bytes a block of each mode takes (trace_smem_bytes), on
  both sides of the 48 KB past which a launch opts in
  (csrc/common.cuh:persistent_blocks).

K7 on the card runs the same guard; tests/test_torch_cuda.py and
chip_smoke.py hold it to these plain versions and to K7 unguarded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench.suite import (bvh_scene_dict,
                                             golden_scene_dict,
                                             ring_scene_dict)
from raytrace_tpu_torch.ops import intersect as tisect
from raytrace_tpu_torch.ops import megakernel as tmk
from raytrace_tpu_torch.ops import shade as tshade
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_trace import camera_lanes

LOOP_SCENES = {"icosphere": lambda: golden_scene_dict(
                   "mesh_smooth_icosphere")[0],
               "ring300": lambda: ring_scene_dict(300),
               "mixed": lambda: bvh_scene_dict("mixed")}


def loop_scene(name):
    s = tscene.from_dict(LOOP_SCENES[name](), device="cpu",
                         build_accel=False)[0]
    assert tmk._kernel_mode(s) == "loop"
    return s


def occluder_count(s):
    g = s.geometry
    return (g.sph_center.shape[0] + g.n_hit_tris + g.box_min.shape[0]
            + g.pl_point.shape[0])


@pytest.mark.parametrize("name", list(LOOP_SCENES))
def test_guarded_soft_loop_is_bit_identical_past_96(name, monkeypatch):
    ts = loop_scene(name)
    n_occl = occluder_count(ts)
    assert n_occl == {"icosphere": 81, "ring300": 301, "mixed": 102}[name]
    W, H = 24, 18
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=8)
    pix = torch.arange(W * H)
    samp = torch.zeros_like(pix)
    o, dd = trender._lane_rays(ts, pix, samp, width=W, height=H, cfg=cfg,
                               go_camera=True)
    o = o.contiguous()
    g = ts.geometry
    hit = tisect.closest_hit(g, o, dd)
    keep = hit.hit.nonzero()[:, 0]
    assert keep.numel() > 10
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
        assert can.shape == (keep.numel(), n_occl)
        flagged += int(can.sum())
        total += can.numel()
    assert flagged < total
    want = ttrace.trace(ts, o, dd, pix, samp, cfg)
    monkeypatch.setattr(tshade, "shadow_factor", tmk.shadow_factor_guarded)
    got = ttrace.trace(ts, o, dd, pix, samp, cfg)
    assert torch.equal(got, want)
    assert (want.sum(-1) > 0).any()


def test_guarded_loop_matches_jax_engine(monkeypatch):
    d = ring_scene_dict(300)
    js = jscene.from_dict(d, build_accel=False)[0]
    ts = loop_scene("ring300")
    o, dd, pix, samp = camera_lanes(js, 12, 9, 2)
    cfg = dict(max_depth=3, shadow_samples=8)
    ref = np.asarray(jtrace.trace(js, jnp.asarray(o), jnp.asarray(dd),
                                  jnp.asarray(pix), jnp.asarray(samp),
                                  jtrace.TraceConfig(**cfg)))
    monkeypatch.setattr(tshade, "shadow_factor", tmk.shadow_factor_guarded)
    got = ttrace.trace(ts, torch.from_numpy(o.copy()),
                       torch.from_numpy(dd.copy()),
                       torch.from_numpy(pix.astype(np.int64)),
                       torch.from_numpy(samp.astype(np.int64)),
                       ttrace.TraceConfig(**cfg)).numpy()
    assert (ref.sum(-1) > 0).any(), "the frame must see geometry"
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def table_bytes(s):
    tabs = tmk.pack_tables(s)
    return 4 * sum(tabs[k].numel() for k in tmk.ORDER)


def test_loop_tables_budget_and_opt_in(monkeypatch):
    """K7 keeps its tables in shared memory up to K3+K4's budget, the most
    an H100 block can take: the icosphere's under 48 KB, ring-2500's past
    it (the launch opts in) and a ring of 12,000 spheres past the budget
    (read in place)."""
    assert tmk.LOOP_SMEM_BYTES == tmk.BVH_SMEM_BYTES == 232_448
    ico = loop_scene("icosphere")
    ring = tscene.from_dict(ring_scene_dict(2500), device="cpu",
                            build_accel=False)[0]
    big = tscene.from_dict(ring_scene_dict(12000), device="cpu",
                           build_accel=False)[0]
    for s, in_smem in ((ico, True), (ring, True), (big, False)):
        assert tmk._kernel_mode(s) == "loop"
        flat, dims, extra = tmk.trace_tables(s, "loop")
        assert extra is in_smem
        assert 4 * flat.numel() == table_bytes(s)
        assert dims[10:] == [0, 0, 0]
        assert tmk.loop_tables_in_smem(tmk.pack_tables(s)) is in_smem
        assert tmk.trace_smem_bytes(s) == (table_bytes(s) if in_smem else 0)
    assert table_bytes(ico) <= 48 * 1024 < table_bytes(ring)
    assert table_bytes(big) > tmk.LOOP_SMEM_BYTES
    # the budget's edge, to the byte
    monkeypatch.setattr(tmk, "LOOP_SMEM_BYTES", table_bytes(ring))
    assert tmk.trace_tables(ring, "loop")[2] is True
    monkeypatch.setattr(tmk, "LOOP_SMEM_BYTES", table_bytes(ring) - 4)
    assert tmk.trace_tables(ring, "loop")[2] is False
    assert tmk.trace_smem_bytes(ring) == 0


def test_trace_smem_bytes_by_mode(monkeypatch):
    """K1 takes its tables, K3+K4 its walk table (within BVH_SMEM_BYTES),
    K5 nothing: its rows stay in global memory."""
    bench = tscene.from_dict(golden_scene_dict("spheres_metal_glass")[0],
                             device="cpu")[0]
    assert tmk._kernel_mode(bench) == "unroll"
    assert tmk.trace_smem_bytes(bench) == table_bytes(bench)
    mixed = tscene.from_dict(bvh_scene_dict("mixed"), device="cpu")[0]
    assert tmk._kernel_mode(mixed) == "bvh"
    walk = 4 * tmk.pack_walk_table(mixed).numel()
    assert tmk.trace_smem_bytes(mixed) == walk
    monkeypatch.setattr(tmk, "BVH_SMEM_BYTES", walk - 16)
    assert tmk.trace_smem_bytes(mixed) == 0
    monkeypatch.setattr(tmk, "UNROLL_PRIM_LIMIT", 4)
    monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 8)
    stream = tscene.with_accel(tscene.from_dict(
        bvh_scene_dict("mixed"), device="cpu", build_accel=False)[0],
        leaf_size=4)
    assert tmk._kernel_mode(stream) == "stream"
    assert tmk.trace_smem_bytes(stream) == 0
