"""The port's OBJ meshes against raytrace_tpu.models.mesh.

parse_obj, load_obj, place_mesh, place_normals, mesh_triangles and
mesh_from_dict on assets/mesh_demo.obj (flat) and assets/icosphere.obj
(with vertex normals), and on an inline OBJ with fans, negative indices
and dangling normals. Both sides are numpy, so every result must be
exactly equal.
"""

import os

import numpy as np
import pytest

from raytrace_tpu.models import mesh as jmesh
from raytrace_tpu_torch.models import mesh as tmesh

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
OBJS = ("mesh_demo.obj", "icosphere.obj")

INLINE = """# a quad fan, a negative index and a dangling normal
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
f 1//1 2//1 3//1 4//1
f -4 -3 -2
f 1//9 3//1 4//1
f 1 1 2
"""


def assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("normals", [False, True])
def test_parse_obj_equal(normals):
    for name in OBJS:
        got = tmesh.load_obj(os.path.join(ASSETS, name),
                             return_normals=normals)
        assert_same(got, jmesh.load_obj(os.path.join(ASSETS, name),
                                        return_normals=normals))
    assert_same(tmesh.parse_obj(INLINE, return_normals=normals),
                jmesh.parse_obj(INLINE, return_normals=normals))


@pytest.mark.parametrize("scale,rot", [(1.1, 15.0), ((0.5, 2.0, 1.5), -20.0),
                                       (1.0, 0.0)])
def test_placement_equal(scale, rot):
    v, _, n, _ = jmesh.load_obj(os.path.join(ASSETS, "icosphere.obj"),
                                return_normals=True)
    assert_same(tmesh.place_mesh(v, (1.0, -2.0, 0.5), scale, rot),
                jmesh.place_mesh(v, (1.0, -2.0, 0.5), scale, rot))
    assert_same(tmesh.place_normals(n, scale, rot),
                jmesh.place_normals(n, scale, rot))


@pytest.mark.parametrize("name", OBJS)
@pytest.mark.parametrize("smooth", [True, False])
def test_mesh_from_dict_equal(name, smooth):
    obj = {"type": "mesh", "path": name, "position": [0.3, 0.2, -1.0],
           "scale": [1.1, 0.9, 1.0], "rotationY": 25, "smooth": smooth}
    got = tmesh.mesh_from_dict(obj, ASSETS)
    ref = jmesh.mesh_from_dict(obj, ASSETS)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert len(a) == len(b)
        assert_same(list(a[:3]), list(b[:3]))
        if len(a) > 3:
            assert_same(list(a[3]), list(b[3]))
    if name == "icosphere.obj":
        assert all(len(t) == (4 if smooth else 3) for t in got)


def test_mesh_triangles_partial_normals_are_flat():
    v, f, n, fn = tmesh.parse_obj(INLINE, return_normals=True)
    tris = tmesh.mesh_triangles(v, f, n, fn)
    assert [len(t) for t in tris] == [4, 4, 3, 3]
    assert_same([len(t) for t in tris],
                [len(t) for t in jmesh.mesh_triangles(v, f, n, fn)])
