"""The port's scene tables against raytrace_tpu.scene: exactly equal.

Covers the three demo scenes of the slice under assets/ (cameras mirrored
to +Z, as the bench does) and the three in-slice golden scenes (spheres,
cubes + plane, prism). Tolerance: none - both loaders cast the same
float64 values to float32 in the same order, so every table must match
bit for bit. convert.scene_from_numpy, fed the JAX Scene's leaves, must
give the same tables too.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import make_goldens
from raytrace_tpu import scene as jscene
from raytrace_tpu_torch import convert
from raytrace_tpu_torch import scene as tscene
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


def scene_dict(kind, name):
    return asset_dict(name) if kind == "asset" else golden_dict(name)


def jax_leaves(js):
    """The JAX Scene's tables as numpy, grouped as convert expects."""
    def group(obj):
        return {f.name: np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.name not in ("occl_tris", "tri_vn", "has_advanced",
                                  "textures", "aux_vec", "aux_a", "aux_b")}
    return dict(camera=group(js.camera), geometry=group(js.geometry),
                materials=group(js.materials), lights=group(js.lights))


def assert_tables_equal(ts, js):
    for grp, jg in jax_leaves(js).items():
        tg = getattr(ts, grp)
        for name, want in jg.items():
            got = getattr(tg, name)
            assert got.dtype in (torch.float32, torch.int32), (grp, name)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{grp}.{name}")
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
        sph_count=js.sph_count, mesh_count=js.mesh_count, device="cpu")
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


@pytest.mark.parametrize("obj,item", [
    ({"type": "mesh", "path": "x.obj"}, "models/mesh.py"),
    ({"type": "sphere", "material": {"type": "sheen"}}, "extended"),
    ({"type": "sphere", "material": {
        "type": "lambertian", "texture": {"type": "checkerboard"}}},
     "models/textures.py"),
])
def test_out_of_slice_features_raise(obj, item):
    with pytest.raises(NotImplementedError, match=item):
        tscene.from_dict({"objects": [obj]}, device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscene.from_dict(golden_dict("prism_perfectmirror"))
