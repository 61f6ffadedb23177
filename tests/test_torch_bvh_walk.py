"""K3+K4's walk table against the JAX package, on the CPU.

* Layout: ``megakernel.pack_walk_table`` is the tree the walks take (the
  JAX package's 4-wide table where ``bvh.wide_walk`` says so, else its
  binary node table) and one 12-float row per leaf slot: the JAX scene's
  sphere and triangle tables gathered through the JAX tree's
  ``prim_index`` (v0, e1, e2 or center, radius; tag and id; cube faces
  tagged 2), on ring-1000, the mixed scene, smooth_shading_demo and a
  pair of 80-triangle icospheres.
* Walks: the table's plain version (``walk_table_plain``, which reads
  nothing but the table) equals ``raytrace_tpu.bvh.traverse_closest``
  and ``traverse_any`` at tolerance 0 on rays seeded with numpy (the JAX
  walks run op by op under ``jax.disable_jit``); on the twin scene's
  exact ties the binary table takes the JAX walk's copies, and the 4-wide
  table the copies of ``bvh.traverse_closest_wide`` (the port's plain
  K3-wide walk, held to the JAX kernel in test_torch_wide.py).
* Budget: the table goes to shared memory up to ``BVH_SMEM_BYTES``
  exactly, and past it is read in place; the 4096-primitive cap at leaf
  size 16 fits, the same scene on a tree of 4-primitive leaves does not.
* Wrapper: on the CPU ``megakernel.trace`` takes the plain engine in bvh
  mode, and ``prepare_trace`` raises, with either design.

Small sizes only; no Pallas interpret call.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu import bvh as jbvh
from raytrace_tpu import scene as jscene
from raytrace_tpu.ops import megakernel as jmk
from raytrace_tpu_torch import bvh as tbvh
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench import suite
from raytrace_tpu_torch.ops import megakernel as tmk

from test_torch_bvh import random_rays
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_trace import camera_lanes

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
BIG = 3.0e38


def both(name, tmp_path):
    """(JAX scene, port scene) of a bvh-mode case by name."""
    if name == "smooth":
        path = os.path.join(ASSETS, "smooth_shading_demo.json")
        return jscene.load(path)[0], tscene.load(path, device="cpu")[0]
    if name == "ico80":
        d = suite.mesh_scene_dict(str(tmp_path), subdiv=1)
    else:
        d = suite.bvh_scene_dict(name)
    return jscene.from_dict(d)[0], tscene.from_dict(d, device="cpu")[0]


def jax_rows(js):
    """The walk rows from the JAX scene's tables and tree, in numpy."""
    g = js.geometry
    c, r = np.asarray(g.sph_center), np.asarray(g.sph_radius)
    v0, v1, v2 = (np.asarray(getattr(g, f)) for f in ("tri_v0", "tri_v1",
                                                     "tri_v2"))
    ns, nt = c.shape[0], v0.shape[0]
    hit = nt if g.occl_tris < 0 else g.occl_tris
    rows = []
    for pid in np.asarray(js.accel.prim_index):
        row = np.zeros(12, np.float32)
        if pid < ns:
            row[0:3], row[3], row[9], row[10] = c[pid], r[pid], 0, pid
        elif pid - ns < hit:
            t = pid - ns
            row[0:3], row[3:6], row[6:9] = v0[t], v1[t] - v0[t], v2[t] - v0[t]
            row[9], row[10] = 1, t
        else:
            row[9], row[10] = 2, pid - ns
        rows.append(row)
    return np.stack(rows)


def jax_nodes(ja, wide):
    if wide:
        return np.asarray(jmk.pack_bvh4_tables(ja.wide4)).T.reshape(-1)
    cols = [np.asarray(ja.node_min), np.asarray(ja.node_max)] + [
        np.asarray(getattr(ja, f)).astype(np.float32)[:, None]
        for f in ("node_skip", "node_first", "node_count")]
    flat = np.concatenate(cols, 1).reshape(-1)
    return np.concatenate([flat, np.zeros((-flat.size) % 4, np.float32)])


@pytest.mark.parametrize("name", ["ring1000", "mixed", "smooth", "ico80"])
def test_walk_table_matches_jax_tables(name, tmp_path):
    js, ts = both(name, tmp_path)
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(js) == "bvh"
    assert tbvh.wide_walk(ts.accel)
    walk = tmk.pack_walk_table(ts)
    assert walk.dtype == torch.float32 and walk.numel() % 4 == 0
    nodes = jax_nodes(js.accel, wide=True)
    got = walk.numpy()
    np.testing.assert_array_equal(got[:nodes.size], nodes)
    rows = got[nodes.size:].reshape(-1, tmk.WALK_ROW)
    np.testing.assert_array_equal(rows, jax_rows(js))
    tags = set(rows[:, 9].tolist())
    assert tags == {0.0, 1.0, 2.0} if name == "mixed" else tags <= {0.0, 1.0}
    # the binary tree where the walks take it (no 4-wide view)
    binary = dataclasses.replace(ts, accel=dataclasses.replace(
        ts.accel, wide4=None))
    got = tmk.pack_walk_table(binary).numpy()
    nodes = jax_nodes(js.accel, wide=False)
    np.testing.assert_array_equal(got[:nodes.size], nodes)
    np.testing.assert_array_equal(
        got[nodes.size:].reshape(-1, tmk.WALK_ROW), rows)
    # trace_tables hands it to K3+K4, beside the scene tables alone (the
    # trees and prim_index are not packed after them)
    flat, dims, extra = tmk.trace_tables(ts, "bvh")
    assert torch.equal(extra, walk)
    assert dims[10:] == [ts.accel.n_nodes, ts.accel.leaf_size,
                         ts.accel.wide4.shape[0]]
    tabs = tmk.pack_tables(ts)
    assert torch.equal(flat, torch.cat([tabs[k].reshape(-1)
                                        for k in tmk.ORDER]))


@pytest.mark.parametrize("name", ["ring100", "mixed", "ico80"])
def test_walk_table_plain_matches_jax_walks(name, tmp_path):
    js, ts = both(name, tmp_path)
    o, d, t_max = random_rays(2048, 21)
    ja = [jnp.asarray(a) for a in (o, d, t_max)]
    with jax.disable_jit():
        jt, jp = jbvh.traverse_closest(js.accel, js.geometry, ja[0], ja[1])
        jb = jbvh.traverse_any(js.accel, js.geometry, ja[0], ja[1], 1e-3,
                               ja[2])
    to, td, tm = (torch.from_numpy(a) for a in (o, d, t_max))
    for s in (ts, dataclasses.replace(ts, accel=dataclasses.replace(
            ts.accel, wide4=None))):
        tt, tp = tmk.walk_table_plain(s, to, td, 1e-3, BIG)
        assert (tp >= 0).any() and (tp < 0).any()
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        tb = tmk.walk_table_plain(s, to, td, 1e-3, tm, any_hit=True)
        assert tb.any() and (~tb).any()
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_walk_table_plain_tie_order():
    """The twin scene (clusters of coincident spheres, leaf size 1): the
    binary table takes the JAX walk's copy on every ray, the 4-wide table
    the port's plain 4-wide walk's, and the two differ on some rays."""
    d = suite.twin_scene_dict()
    js = jscene.with_accel(jscene.from_dict(d)[0], leaf_size=1)
    ts = tscene.with_accel(tscene.from_dict(d, device="cpu")[0],
                           leaf_size=1)
    o, d_, _, _ = camera_lanes(js, 24, 18, 1)
    with jax.disable_jit():
        jt, jp = jbvh.traverse_closest(js.accel, js.geometry,
                                       jnp.asarray(o), jnp.asarray(d_))
    to, td = torch.from_numpy(o.copy()), torch.from_numpy(d_.copy())
    binary = dataclasses.replace(ts, accel=dataclasses.replace(
        ts.accel, wide4=None))
    bt, bp = tmk.walk_table_plain(binary, to, td, 1e-3, BIG)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jt))
    wt, wp = tmk.walk_table_plain(ts, to, td, 1e-3, BIG)
    rt, rp = tbvh.traverse_closest_wide(ts.accel, ts.geometry, to, td)
    assert torch.equal(wp, rp) and torch.equal(wt, rt)
    assert torch.equal(wt, bt)
    assert int((wp != bp).sum()) >= 5


def test_walk_table_budget_edges(monkeypatch):
    """Shared memory up to BVH_SMEM_BYTES exactly; the 4096-primitive cap
    fits at leaf size 16 and not on 4-primitive leaves."""
    assert tmk.BVH_SMEM_BYTES == 232_448
    fits = torch.zeros(tmk.BVH_SMEM_BYTES // 4)
    assert tmk.walk_table_in_smem(fits)
    assert not tmk.walk_table_in_smem(torch.zeros(fits.numel() + 4))
    cap = tscene.from_dict(suite.ring_scene_dict(4095), device="cpu")[0]
    assert cap.prim_count == tmk.MAX_BVH_KERNEL_PRIMS
    assert tmk._kernel_mode(cap) == "bvh" and cap.accel.leaf_size == 16
    walk = tmk.pack_walk_table(cap)
    assert 200_000 < 4 * walk.numel() <= tmk.BVH_SMEM_BYTES
    small = tscene.with_accel(cap, leaf_size=4)
    assert tmk._kernel_mode(small) == "bvh"
    assert not tmk.walk_table_in_smem(tmk.pack_walk_table(small))
    mixed = tscene.from_dict(suite.bvh_scene_dict("mixed"), device="cpu")[0]
    walk = tmk.pack_walk_table(mixed)
    monkeypatch.setattr(tmk, "BVH_SMEM_BYTES", 4 * walk.numel())
    assert tmk.walk_table_in_smem(walk)
    monkeypatch.setattr(tmk, "BVH_SMEM_BYTES", 4 * walk.numel() - 16)
    assert not tmk.walk_table_in_smem(walk)


def test_trace_cpu_branch_and_prepare_raises():
    ts = tscene.from_dict(suite.bvh_scene_dict("mixed"), device="cpu")[0]
    js = jscene.from_dict(suite.bvh_scene_dict("mixed"))[0]
    lanes = tuple(torch.from_numpy(a.copy()).to(t) for a, t in zip(
        camera_lanes(js, 8, 6, 2),
        (torch.float32, torch.float32, torch.int64, torch.int64)))
    cfg = ttrace.TraceConfig(max_depth=4, shadow_samples=2)
    tmk.reset_launches()
    got = tmk.trace(ts, *lanes, cfg)
    assert torch.equal(got, ttrace.trace(ts, *lanes, cfg))
    assert not any(tmk.LAUNCHES.values())
    for guard in (True, False):
        with pytest.raises(RuntimeError, match="not CUDA"):
            tmk.prepare_trace(ts, *lanes, cfg, soft_guard=guard)
