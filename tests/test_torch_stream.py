"""The port's stream tier (past 4096 primitives with a BVH) against the
JAX package, on the CPU.

* The stream table: pack_stream_table equals the first 14 (23 with vertex
  normals) columns of the JAX package's table bit for bit, on a sphere,
  cube and plane scene and on a smooth-shaded mesh; on grid-5833 the
  table that from_dict attaches equals the JAX scene's, and convert
  carries the JAX table across, checked against the port's own.
* The tree: the port's build_scene_bvh equals the JAX package's at leaf
  size 32 on grid-5833's spheres.
* Dispatch: _kernel_mode, scene_fits_kernel and the leaf size equal the
  JAX package's at 4,096 / 4,097 / 262,144 / 262,145 primitives; past
  262,144 the port raises, naming the JAX package's band route.
* The plain stream walk (K5's plain version): closest_hit and any_hit
  over the stream rows are bit-equal to the walks over the scene tables
  on the same tree (random rays), and so is the engine, lane for lane;
  the engine in stream mode equals the JAX jnp engine at 12x8, 2 spp,
  depth 3, within 1e-4.
* The node-only mask (K6-stream's plain version) equals
  pixel_mask_pallas(..., interpret=True) in stream mode at 12x8 (one
  interpret call), and covers every pixel of K6's mask on the same tree.

Stream mode is forced on small scenes by lowering MAX_BVH_KERNEL_PRIMS
(and UNROLL_PRIM_LIMIT) in both packages' megakernel modules, as
tests/test_megakernel.py:281 does.
"""

import dataclasses
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu import bvh as jbvh
from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu.ops import megakernel as jmk
from raytrace_tpu_torch import bvh as tbvh
from raytrace_tpu_torch import convert
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench import suite
from raytrace_tpu_torch.ops import intersect as tisect
from raytrace_tpu_torch.ops import megakernel as tmk
from test_torch_scene import jax_leaves, one_torch_thread  # noqa: F401
from test_torch_split import as_torch, stream_dict
from test_torch_trace import camera_lanes

TREE = ("node_min", "node_max", "node_skip", "node_first", "node_count",
        "prim_index")


@pytest.fixture
def forced(monkeypatch):
    """Lower both packages' stream threshold to 8 primitives."""
    for mk in (jmk, tmk):
        monkeypatch.setattr(mk, "UNROLL_PRIM_LIMIT", 4)
        monkeypatch.setattr(mk, "UNROLL_PRIM_LIMIT_VN", 4)
        monkeypatch.setattr(mk, "MAX_BVH_KERNEL_PRIMS", 8)


def spheres_cube_plane_dict():
    """stream_dict (spheres, a cube, a plane) with a prism, so that the
    table holds every tag: spheres, triangles, cube faces, padding."""
    d = stream_dict()
    d["objects"].append({
        "type": "triangularPrism", "vertices": [
            [-1.0, 0.6, -3.5], [0.0, 1.4, -3.5], [1.0, 0.6, -3.5],
            [-1.0, 0.6, -4.5], [0.0, 1.4, -4.5], [1.0, 0.6, -4.5]],
        "material": {"type": "perfectmirror", "color": [0.9, 0.9, 0.95]}})
    return d


def mesh_dict(tmp_path):
    """ico at subdivision 2 (2 x 320 smooth triangles) over a plane."""
    return suite.mesh_scene_dict(str(tmp_path), subdiv=2)


def both_leaf4(d):
    """(JAX scene, port scene) on leaf-size-4 trees; the port's carries
    the stream table when built in stream mode."""
    js = jscene.with_accel(jscene.from_dict(d, build_accel=False)[0],
                           leaf_size=4)
    ts = tscene.with_accel(tscene.from_dict(d, device="cpu",
                                            build_accel=False)[0],
                           leaf_size=4)
    return js, ts


def assert_tree_equal(ta, ja):
    for f in TREE:
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    assert ta.leaf_size == ja.leaf_size


@pytest.mark.parametrize("kind", ["spheres_cube_plane", "smooth_mesh"])
def test_pack_stream_table_matches_jax(kind, forced, tmp_path):
    d = (spheres_cube_plane_dict() if kind == "spheres_cube_plane"
         else mesh_dict(tmp_path))
    js, ts = both_leaf4(d)
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(js) == "stream"
    assert_tree_equal(ts.accel, js.accel)
    got = ts.accel.stream_tab
    cols = 14 if kind == "spheres_cube_plane" else 23
    assert got.shape == (ts.accel.prim_index.shape[0] + 4, cols)
    want = np.asarray(jmk.pack_stream_table(js))
    np.testing.assert_array_equal(got.numpy(), want[:, :cols])
    tags = set(got[:, 0].tolist())
    assert tags == ({-1.0, 0.0, 1.0, 2.0} if kind == "spheres_cube_plane"
                    else {-1.0, 1.0})
    assert torch.equal(tmk.pack_stream_table(ts), got)


@pytest.fixture(scope="module")
def grid_pair():
    d = suite.grid_scene_dict()
    return jscene.from_dict(d)[0], tscene.from_dict(d, device="cpu")[0]


def test_grid_tree_and_table_match_jax(grid_pair):
    js, ts = grid_pair
    assert ts.prim_count == 5833
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(js) == "stream"
    jtree = jbvh.build_scene_bvh(js.geometry, 32)
    ttree = tbvh.build_scene_bvh(ts.geometry, 32)
    assert_tree_equal(ttree, jtree)
    assert_tree_equal(ts.accel, js.accel)
    np.testing.assert_array_equal(ts.accel.stream_tab.numpy(),
                                  np.asarray(js.accel.stream_tab)[:, :14])


def test_convert_carries_the_stream_table(grid_pair):
    js, ts = grid_pair
    leaves = jax_leaves(js)
    accel = {f: np.asarray(getattr(js.accel, f)) for f in TREE}
    accel["leaf_size"] = js.accel.leaf_size
    accel["stream_tab"] = np.asarray(js.accel.stream_tab)
    kw = dict(occl_tris=js.geometry.occl_tris, device="cpu")
    cs = convert.scene_from_numpy(**leaves, accel=accel, **kw)
    assert torch.equal(cs.accel.stream_tab, ts.accel.stream_tab)
    bad = dict(accel, stream_tab=accel["stream_tab"].copy())
    bad["stream_tab"][3, 4] += 1.0
    with pytest.raises(ValueError, match="stream table"):
        convert.scene_from_numpy(**leaves, accel=bad, **kw)


def fake_scene(n):
    """A scene-shaped stand-in with n spheres and a BVH, for the dispatch
    functions of both packages (they read shapes only)."""
    geom = types.SimpleNamespace(sph_center=np.empty((n, 3), np.float32),
                                 tri_v0=np.empty((0, 3), np.float32),
                                 pl_point=np.empty((0, 3), np.float32),
                                 tri_vn=None)
    return types.SimpleNamespace(geometry=geom, accel=object(),
                                 prim_count=n)


@pytest.mark.parametrize("n", [4096, 4097, 262_144, 262_145])
def test_dispatch_matches_jax_at_the_stream_edges(n):
    s = fake_scene(n)
    assert tmk._kernel_mode(s) == jmk._kernel_mode(s)
    assert tmk.scene_fits_kernel(s) == jmk.scene_fits_kernel(s)
    assert tscene._accel_leaf_size(n) == jscene._accel_leaf_size(n)
    # past the JAX package's cap (scene_fits_kernel False) the port stays
    # in stream mode: its past-cap route
    assert tmk.require_mode(s) == jmk._kernel_mode(s)


def random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32) + np.float32(
        [0, 0, -4])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def without_table(ts):
    return dataclasses.replace(ts, accel=dataclasses.replace(
        ts.accel, stream_tab=None))


@pytest.mark.parametrize("kind", ["spheres_cube_plane", "smooth_mesh"])
def test_stream_walk_bit_equal_to_bvh_walk(kind, forced, tmp_path):
    d = (spheres_cube_plane_dict() if kind == "spheres_cube_plane"
         else mesh_dict(tmp_path))
    js, ts = both_leaf4(d)
    tree = without_table(ts)
    g = ts.geometry
    o, dd = random_rays(4096, 7)
    h_rows = tisect.closest_hit(g, o, dd, accel=ts.accel)
    h_tree = tisect.closest_hit(g, o, dd, accel=tree.accel)
    assert h_rows.hit.any()
    for f in h_rows._fields:
        assert torch.equal(getattr(h_rows, f), getattr(h_tree, f)), f
    for exact in (False, True):
        tm = torch.full((4096,), 5.0)
        a = tisect.any_hit(g, o, dd, 1e-3, tm, accel=ts.accel, exact=exact)
        b = tisect.any_hit(g, o, dd, 1e-3, tm, accel=tree.accel,
                           exact=exact)
        assert a.any() and torch.equal(a, b)
    lanes = as_torch(*camera_lanes(js, 16, 12, 2))
    cfg = ttrace.TraceConfig(max_depth=6, shadow_samples=4)
    got = tmk.trace(ts, *lanes, cfg)
    assert got.any()
    assert torch.equal(got, ttrace.trace(tree, *lanes, cfg))


def test_stream_engine_matches_jax_jnp(forced):
    js, ts = both_leaf4(spheres_cube_plane_dict())
    o, dd, pix, samp = camera_lanes(js, 12, 8, 2)
    ref = np.asarray(jtrace.trace(
        js, jnp.asarray(o), jnp.asarray(dd), jnp.asarray(pix),
        jnp.asarray(samp), jtrace.TraceConfig(max_depth=3,
                                              shadow_samples=2)))
    got = tmk.trace(ts, *as_torch(o, dd, pix, samp),
                    ttrace.TraceConfig(max_depth=3, shadow_samples=2))
    assert (ref.sum(-1) > 0).mean() >= 0.5
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def test_node_only_mask_matches_pallas_interpret(forced, monkeypatch):
    W, H = 12, 8
    d = stream_dict()
    d["objects"] = d["objects"][:-1]   # without the plane: hits and misses
    d["camera"]["position"] = [0, 2, 9]
    js, ts = both_leaf4(d)
    pix = np.arange(W * H, dtype=np.uint32)
    ref = np.asarray(jmk.pixel_mask_pallas(
        js, jnp.asarray((pix % W).astype(np.float32)),
        jnp.asarray((pix // W).astype(np.float32)), width=W, height=H,
        cfg=jtrace.TraceConfig(), interpret=True)) > 0.0
    got = tmk.pixel_mask_plain(ts, width=W, height=H,
                               cfg=ttrace.TraceConfig())
    assert ref.any() and (~ref).any(), "the frame must mix hits and misses"
    np.testing.assert_array_equal(got.numpy(), ref)
    # K6 on the same tree passes a subset
    monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 4096)
    assert tmk._kernel_mode(ts) == "bvh"
    k6 = tmk.pixel_mask_plain(ts, width=W, height=H,
                              cfg=ttrace.TraceConfig())
    assert not (k6 & ~got).any()


def test_stream_trace_tables():
    ts = tscene.from_dict(suite.grid_scene_dict(side=17), device="cpu")[0]
    assert ts.prim_count == 4914 and tmk._kernel_mode(ts) == "stream"
    flat, dims, rows = tmk.trace_tables(ts, "stream")
    ns, nt, npl, nb, nl, nm, tri_cols = dims[:7]
    assert (ns, nt, npl, tri_cols) == (0, 0, 1, 13)
    # the node table and then the 4-wide table (K3-wide: the JAX kernel
    # takes it at this size), after the scene tables
    n_wide = ts.accel.wide4.shape[0]
    assert dims[10:] == [ts.accel.n_nodes, 32, n_wide]
    nodes, _ = tmk.pack_bvh_tables(ts.accel)
    assert torch.equal(flat[-36 * n_wide:], ts.accel.wide4.reshape(-1))
    assert torch.equal(flat[-36 * n_wide - nodes.numel():-36 * n_wide],
                       nodes.reshape(-1))
    assert rows is ts.accel.stream_tab and rows.shape[1] == tri_cols + 1
