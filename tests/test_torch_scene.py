"""The port's scene tables against raytrace_tpu.scene: exactly equal.

Covers the demo scenes under assets/ (the first three with cameras
mirrored to +Z, as the bench does; the mesh, smooth-shading and
textured-mirror demos loaded from their files, so mesh paths resolve
against the file's directory) and the golden scenes (spheres, cubes +
plane, prism, extended kinds + texture, smooth icosphere mesh).
Tolerance: none - both loaders cast the same float64 values to float32
in the same order, so every table (vertex normals, extended-kind
columns, texture bindings and the scene BVH included) must match bit for
bit, and the kernel mode must be the JAX package's.
convert.scene_from_numpy, fed the JAX Scene's leaves, must give the same
tables too.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import make_goldens
from raytrace_tpu import scene as jscene
from raytrace_tpu.ops import megakernel as jmk
from raytrace_tpu_torch import convert
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.ops import megakernel as tmk

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
SLICE_ASSETS = ("sphere_reflections_light", "two_red_cubes_scene",
                "final_silver_prism_purple_cube")
SLICE_GOLDENS = ("spheres_metal_glass", "cubes_dielectric_plane",
                 "prism_perfectmirror")


def asset_dict(name):
    with open(os.path.join(ASSETS, f"{name}.json")) as f:
        d = json.load(f)
    d["camera"]["position"][2] = -d["camera"]["position"][2]
    return d


def golden_dict(name):
    return {n: d for n, d, _ in make_goldens.scenes()}[name]


CASES = ([("asset", n) for n in SLICE_ASSETS]
         + [("golden", n) for n in SLICE_GOLDENS])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU tests: the plain engine runs
    thousands of small ops, and in a parallel test run each worker's own
    thread pool oversubscribes the cores (a bvh render measured 96 s with
    8 threads under load, 4 s with 1). Imported by the other port test
    modules that run the plain engine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_dict(kind, name):
    return asset_dict(name) if kind == "asset" else golden_dict(name)


def jax_leaves(js):
    """The JAX Scene's tables as numpy, grouped as convert expects (the
    vertex normals only when the scene has them)."""
    def group(obj):
        return {f.name: np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.name not in ("occl_tris", "tri_vn", "has_advanced",
                                  "textures")}
    leaves = dict(camera=group(js.camera), geometry=group(js.geometry),
                  materials=group(js.materials), lights=group(js.lights))
    if js.geometry.tri_vn is not None:
        leaves["geometry"]["tri_vn"] = np.asarray(js.geometry.tri_vn)
    leaves["materials"]["has_advanced"] = js.materials.has_advanced
    return leaves


def jax_textures(js):
    """The JAX table's texture bindings as convert takes them."""
    return [(i, type(t).__name__, dataclasses.asdict(t))
            for i, t in js.materials.textures]


TREE = ("node_min", "node_max", "node_skip", "node_first", "node_count",
        "prim_index")


def assert_tables_equal(ts, js):
    for grp, jg in jax_leaves(js).items():
        tg = getattr(ts, grp)
        for name, want in jg.items():
            got = getattr(tg, name)
            if name == "has_advanced":
                assert got == want
                continue
            assert got.dtype in (torch.float32, torch.int32), (grp, name)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{grp}.{name}")
    assert (ts.geometry.tri_vn is None) == (js.geometry.tri_vn is None)
    assert [(i, type(t).__name__, dataclasses.asdict(t))
            for i, t in ts.materials.textures] == jax_textures(js)
    assert (ts.accel is None) == (js.accel is None)
    if ts.accel is not None:
        assert ts.accel.leaf_size == js.accel.leaf_size
        for name in TREE:
            np.testing.assert_array_equal(
                getattr(ts.accel, name).numpy(),
                np.asarray(getattr(js.accel, name)), err_msg=name)
    assert ts.geometry.occl_tris == js.geometry.occl_tris
    assert ts.sph_count == js.sph_count
    assert ts.mesh_count == js.mesh_count


@pytest.mark.parametrize("kind,name", CASES, ids=[c[1] for c in CASES])
def test_from_dict_tables_equal(kind, name):
    d = scene_dict(kind, name)
    js, jcfg = jscene.from_dict(d)
    ts, tcfg = tscene.from_dict(d, device="cpu")
    assert_tables_equal(ts, js)
    assert tcfg.renderer == jcfg.renderer
    assert ts.num_objects == js.num_objects


@pytest.mark.parametrize("kind,name", CASES, ids=[c[1] for c in CASES])
def test_scene_from_numpy_equal(kind, name):
    js, _ = jscene.from_dict(scene_dict(kind, name))
    ts = convert.scene_from_numpy(
        **jax_leaves(js), occl_tris=js.geometry.occl_tris,
        sph_count=js.sph_count, mesh_count=js.mesh_count,
        accel=None if js.accel is None else {
            **{k: np.asarray(getattr(js.accel, k)) for k in TREE},
            "leaf_size": js.accel.leaf_size}, device="cpu")
    assert_tables_equal(ts, js)


def test_load_matches_from_dict():
    path = os.path.join(ASSETS, "two_red_cubes_scene.json")
    js, _ = jscene.load(path)
    ts, _ = tscene.load(path, device="cpu")
    assert_tables_equal(ts, js)


def test_kernel_tables_match_jax_pack():
    """The mask tables (affine camera, cone bound, bounding spheres) equal
    the JAX package's host-side packers bit for bit."""
    from raytrace_tpu.ops import megakernel as jmk
    d = golden_dict("cubes_dielectric_plane")
    js, _ = jscene.from_dict(d)
    ts, _ = tscene.from_dict(d, device="cpu")
    cam = tmk._affine_camera(ts, True)
    np.testing.assert_array_equal(cam.numpy(),
                                  np.asarray(jmk._affine_camera(js, True)))
    np.testing.assert_array_equal(
        tmk._cone_half_sin(cam, 96, 72).numpy(),
        np.asarray(jmk._cone_half_sin(js, True, 96, 72)))
    np.testing.assert_array_equal(tmk._bsphere_table(ts).numpy(),
                                  np.asarray(jmk._bsphere_table(js)).T)
    sph, tri, pln, lit, mat = (np.asarray(a) for a in jmk.pack_tables(js))
    tabs = tmk.pack_tables(ts)
    nt = ts.geometry.n_hit_tris
    np.testing.assert_array_equal(tabs["sph"].numpy(), sph.T)
    np.testing.assert_array_equal(tabs["tri"].numpy(), tri.T[:nt])
    np.testing.assert_array_equal(tabs["pln"].numpy(), pln.T)
    np.testing.assert_array_equal(tabs["lit"].numpy(), lit.T)
    np.testing.assert_array_equal(tabs["mat"].numpy(), mat.T)


def test_go_parity_skips_prisms_and_planes():
    d = golden_dict("cubes_dielectric_plane")
    js, _ = jscene.from_dict(d, go_parity=True)
    ts, _ = tscene.from_dict(d, go_parity=True, device="cpu")
    assert ts.geometry.pl_point.shape[0] == 0
    assert_tables_equal(ts, js)


EXT_ASSETS = ("mesh_demo", "smooth_shading_demo", "textured_mirror_demo")
EXT_GOLDENS = ("extended_textured", "mesh_smooth_icosphere")
EXT_CASES = ([("asset", n) for n in EXT_ASSETS]
             + [("golden", n) for n in EXT_GOLDENS])


def ext_scenes(kind, name, **kw):
    """(JAX scene, port scene) of a scene of this slice: an asset loaded
    from its file, or a golden scene's dict."""
    if kind == "asset":
        path = os.path.join(ASSETS, f"{name}.json")
        return (jscene.load(path, **kw)[0],
                tscene.load(path, device="cpu", **kw)[0])
    d = golden_dict(name)
    return (jscene.from_dict(d, **kw)[0],
            tscene.from_dict(d, device="cpu", **kw)[0])


@pytest.mark.parametrize("kind,name", EXT_CASES,
                         ids=[c[1] for c in EXT_CASES])
def test_extended_scene_tables_equal(kind, name):
    js, ts = ext_scenes(kind, name)
    assert_tables_equal(ts, js)
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(js)
    sph, tri, pln, lit, mat = (np.asarray(a) for a in jmk.pack_tables(js))
    tabs = tmk.pack_tables(ts)
    nt = ts.geometry.n_hit_tris
    np.testing.assert_array_equal(tabs["tri"].numpy(), tri.T[:nt])
    np.testing.assert_array_equal(tabs["mat"].numpy(), mat.T)
    assert tabs["tex"].shape[0] == len(ts.materials.textures)


def test_extended_scenes_cover_the_slice():
    """The slice's scenes carry what they are chosen for, and their modes
    are the JAX package's: the icosphere golden without its BVH runs loop
    mode there (81 primitives, vertex normals)."""
    got = {n: ext_scenes(k, n)[1] for k, n in EXT_CASES}
    assert got["smooth_shading_demo"].geometry.tri_vn is not None
    assert got["mesh_smooth_icosphere"].geometry.tri_vn is not None
    assert got["mesh_demo"].geometry.tri_vn is None
    assert got["textured_mirror_demo"].materials.textures
    assert got["extended_textured"].materials.has_advanced
    assert [tmk._kernel_mode(got[n]) for n in EXT_ASSETS + EXT_GOLDENS] == [
        "unroll", "bvh", "unroll", "unroll", "bvh"]
    js, ts = ext_scenes("golden", "mesh_smooth_icosphere",
                        build_accel=False)
    assert_tables_equal(ts, js)
    assert tmk._kernel_mode(ts) == jmk._kernel_mode(js) == "loop"


@pytest.mark.parametrize("name", EXT_GOLDENS)
def test_scene_from_numpy_traces_the_same(name):
    """convert.scene_from_numpy on the JAX package's tables (vertex
    normals, extended columns, texture bindings) traces the same radiance,
    lane for lane, as the port's own from_dict."""
    js, ts = ext_scenes("golden", name)
    cs = convert.scene_from_numpy(
        **jax_leaves(js), occl_tris=js.geometry.occl_tris,
        sph_count=js.sph_count, mesh_count=js.mesh_count,
        accel=None if js.accel is None else {
            **{k: np.asarray(getattr(js.accel, k)) for k in TREE},
            "leaf_size": js.accel.leaf_size},
        textures=jax_textures(js), device="cpu")
    assert_tables_equal(cs, js)
    cfg = ttrace.TraceConfig(max_depth=6, shadow_samples=4)
    kw = dict(width=24, height=18, cfg=cfg, go_camera=True)
    pix = torch.arange(24 * 18)
    samp = torch.zeros_like(pix)
    a = trender.lane_radiance(cs, pix, samp, **kw)
    b = trender.lane_radiance(ts, pix, samp, **kw)
    assert (b.sum(-1) > 0).any()
    assert torch.equal(a, b)


@pytest.mark.parametrize("feature", ["post effects", "depth of field"])
def test_scene_config_features_render(feature):
    """Scene-config and camera features render: atmosphere_demo.json's
    atmospheric, fog and volumetric blocks, and depth of field."""
    r = trender.Renderer(device="cpu")
    r.set_samples(1)
    if feature == "post effects":
        path = os.path.join(ASSETS, "atmosphere_demo.json")
        ts, cfg = tscene.load(path, device="cpu")
        img = r.render(ts, 8, 6, scene_config=cfg)
        plain = r.render(ts, 8, 6)
        # the go camera sees only sky, which the atmosphere paints in
        assert plain.max() == 0 and img.min() > 0
    else:
        ts = tscene.from_dict(golden_dict("prism_perfectmirror"),
                              device="cpu")[0]
        r.set_depth_of_field(True)
        img = r.render(ts, 8, 6)
        assert img.shape == (6, 8, 3) and img.any()


def test_out_of_slice_features_raise(monkeypatch):
    """What the kernels cannot take raises, naming why: a scene past
    MAX_STREAM_ROWS primitives, whose leaf offsets the stream node table
    cannot hold exactly (the limit is lowered here below the scene's 4,097
    primitives). Past MAX_STREAM_KERNEL_PRIMS alone, where the JAX package
    takes its band route, the port renders."""
    r = trender.Renderer(device="cpu")
    r.set_samples(1)
    r.set_max_depth(2)
    d = {"objects": [{"type": "sphere", "position": [i % 64, i // 64, -5],
                      "radius": 0.2} for i in range(4097)]}
    ts = tscene.from_dict(d, device="cpu")[0]
    monkeypatch.setattr(tmk, "MAX_STREAM_KERNEL_PRIMS", 4096)
    assert r.render(ts, 4, 3).shape == (3, 4, 3)
    monkeypatch.setattr(tmk, "MAX_STREAM_ROWS", 4096)
    with pytest.raises(ValueError, match="float32 integers"):
        r.render(ts, 4, 3)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscene.from_dict(golden_dict("prism_perfectmirror"))


@pytest.mark.parametrize("name", EXT_GOLDENS)
def test_suite_golden_copies_equal(name):
    """bench/suite.py's copies of the golden scenes (for runs without the
    JAX package) load the same tables as tests/make_goldens.py's."""
    from raytrace_tpu_torch.bench.suite import golden_scene_dict
    d, ck = golden_scene_dict(name)
    gold = {n: (g, c) for n, g, c in make_goldens.scenes()}[name]
    assert ck == gold[1]
    js = jscene.from_dict(gold[0])[0]
    assert_tables_equal(tscene.from_dict(d, device="cpu")[0], js)
