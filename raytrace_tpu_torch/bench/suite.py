"""Benchmark and check scenes of the port: a copy of the JAX package's
``bench/suite.py:ring_scene_dict`` (the benchmark sweep is not ported),
the bvh-mode scenes that the tests and ``chip_smoke.py`` share, copies
of five golden scenes of ``tests/make_goldens.py`` (``golden_scene_dict``),
a scene of exact ties for the walks' order (``twin_scene_dict``), and
copies of the JAX package's two stream-mode workloads of
``tools/tpu_stream_smoke.py`` (``grid_scene_dict``, ``icosphere_obj``,
``mesh_scene_dict``), grid-1001 of its gradient measurements
(``grad_grid_scene_dict``) and the two scenes of its gradient tests
(``diff_scene_dict``), for runs that may not import the JAX package."""

from __future__ import annotations

import copy
import math
import os

import numpy as np

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "assets")


def ring_scene_dict(n_spheres: int = 10, radius: float = 5.0):
    """The reference benchmark's synthetic scene family: a ring of spheres
    around (0, 0, -8) with mixed materials, plus a ground sphere standing
    in for a plane (the reference JSON schema has no planes)."""
    objs = [{"type": "sphere", "position": [0, -1000.5, 0], "radius": 1000,
             "material": {"type": "lambertian", "color": [0.5, 0.5, 0.5]}}]
    mats = [{"type": "lambertian", "color": [0.8, 0.3, 0.3]},
            {"type": "metal", "color": [0.8, 0.8, 0.9], "roughness": 0.1},
            {"type": "glass", "color": [0.9, 0.9, 0.9]}]
    for i in range(n_spheres):
        ang = 2.0 * math.pi * i / n_spheres
        objs.append({
            "type": "sphere",
            "position": [radius * math.cos(ang), 0.0,
                         radius * math.sin(ang) - 8.0],
            "radius": 0.5,
            "material": mats[i % len(mats)],
        })
    return {
        "camera": {"position": [0, 1, 8], "aspectRatio": 1.333},
        "objects": objs,
        "lights": [{"type": "point", "position": [5, 10, 5],
                    "color": [1, 1, 1], "intensity": 2.0}],
    }


# The prism and the two cubes (the second one the ground) of
# assets/final_silver_prism_purple_cube.json.
_PRISM_AND_CUBES = [
    {"type": "triangularPrism",
     "vertices": [[-2.2, -0.8, -0.5], [-1.0, -0.8, -0.5], [-1.6, 0.6, -0.5],
                  [-2.2, -0.8, 0.8], [-1.0, -0.8, 0.8], [-1.6, 0.6, 0.8]],
     "material": {"type": "perfectmirror", "color": [0.92, 0.92, 0.95]}},
    {"type": "cube", "position": [1.6, 0, 0], "size": [1.3, 1.3, 1.3],
     "material": {"type": "shiny", "color": [0.55, 0.2, 0.8],
                  "roughness": 0.15, "specular": 0.9}},
    {"type": "cube", "position": [0, -501.2, 0], "size": [1000, 1000, 1000],
     "material": {"type": "lambertian", "color": [0.5, 0.5, 0.55]}},
]
_BACK_WALL = {"type": "plane", "position": [0, 0, -20], "normal": [0, 0, 1],
              "material": {"type": "lambertian", "color": [0.4, 0.5, 0.6]}}


def mixed_scene_dict(ground: bool = True):
    """A bvh-mode scene of every kind: a 90-sphere ring and its ground
    sphere, the prism and the two cubes of
    final_silver_prism_purple_cube.json and a back-wall plane.

    With ``ground=False`` the three objects that cover the whole frame
    are left out (the ground sphere, the ground cube and the back wall),
    so the pixel mask's frame holds both hits and misses."""
    d = ring_scene_dict(90)
    extra = copy.deepcopy(_PRISM_AND_CUBES + [_BACK_WALL])
    if ground:
        d["objects"] += extra
    else:
        d["objects"] = d["objects"][1:] + extra[:2]
    return d


def twin_scene_dict():
    """97 primitives: 12 clusters of 8 coincident spheres, each copy of a
    cluster with its own colour, over a ground plane. A ray that hits a
    cluster hits all 8 copies at exactly the same t, so which copy it
    shows is the walk's tie order: built with leaf size 1, the 4-wide walk
    (K3-wide) and the binary walk show different copies on many lanes."""
    cols = ([0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9],
            [0.9, 0.9, 0.1], [0.9, 0.1, 0.9], [0.1, 0.9, 0.9],
            [0.5, 0.5, 0.5], [0.9, 0.5, 0.1])
    objs = [{"type": "sphere", "position": [x, y, -1.0], "radius": 0.45,
             "material": {"type": "lambertian", "color": c}}
            for x in (-1.5, -0.5, 0.5, 1.5) for y in (1.2, 2.0, 2.8)
            for c in cols]
    objs.append({"type": "plane", "position": [0, 0, 0], "normal": [0, 1, 0],
                 "material": {"type": "lambertian",
                              "color": [0.5, 0.5, 0.5]}})
    return {"camera": {"position": [0, 2, 3], "aspectRatio": 1.33},
            "objects": objs,
            "lights": [{"type": "point", "position": [3, 8, 4],
                        "color": [1, 1, 1], "intensity": 2.0}]}


def bvh_scene_dict(name: str):
    """A bvh-mode check scene by name: "ring<N>" (the ring of N spheres),
    "mixed", and either with "-noground" appended, which leaves out what
    covers the whole frame (for the ring, its ground sphere), so that the
    pixel mask meets both hits and misses."""
    base, _, rest = name.partition("-")
    if rest not in ("", "noground"):
        raise ValueError(f"unknown scene {name!r}")
    if base == "mixed":
        return mixed_scene_dict(ground=not rest)
    d = ring_scene_dict(int(base[len("ring"):]))
    if rest:
        d["objects"] = d["objects"][1:]
    return d


def golden_scene_dict(name: str):
    """A golden scene of tests/make_goldens.py by name, with its trace
    settings: (scene dict, TraceConfig keyword arguments).
    "extended_textured": the extended kinds mirror, sheen and emission
    and a checkerboard texture (15 primitives, unroll mode);
    "mesh_smooth_icosphere": an 80-face icosphere with vertex normals
    (assets/icosphere.obj, the goldens' own OBJ) and a ground sphere, 81
    primitives: bvh mode with the BVH that from_dict gives it, loop mode
    without; "spheres_metal_glass", "cubes_dielectric_plane" and
    "prism_perfectmirror": the unroll-mode goldens of spheres, boxes and a
    plane, and a prism's triangles (K1-guard's occluder kinds)."""
    if name == "spheres_metal_glass":
        return {
            "camera": {"position": [0, 0, 8], "aspectRatio": 1.3333},
            "objects": [
                {"type": "sphere", "position": [0, 0, 0], "radius": 1.0,
                 "material": {"type": "metal", "color": [0.8, 0.8, 0.9],
                              "roughness": 0.1, "metallic": 0.95}},
                {"type": "sphere", "position": [-2, 0, 0], "radius": 0.7,
                 "material": {"type": "glass", "color": [0.9, 0.5, 0.5],
                              "refractionIndex": 1.5}},
                {"type": "sphere", "position": [2, 0, 0], "radius": 0.7,
                 "material": {"type": "shiny", "color": [0.4, 0.7, 0.4],
                              "roughness": 0.2, "specular": 0.8}},
                {"type": "sphere", "position": [0, -101, 0], "radius": 100.0,
                 "material": {"type": "lambertian",
                              "color": [0.6, 0.6, 0.55]}},
                {"type": "sphere", "position": [0, 2.2, 0], "radius": 0.5,
                 "material": {"type": "diffuselight",
                              "color": [1, 0.9, 0.7]}},
            ],
            "lights": [
                {"position": [5, 6, 5], "color": [1, 1, 1],
                 "intensity": 40.0},
                {"position": [-4, 3, 3], "color": [0.7, 0.8, 1.0],
                 "intensity": 15.0},
            ],
        }, dict(max_depth=8, shadow_samples=8)
    if name == "cubes_dielectric_plane":
        return {
            "camera": {"position": [0, 1, 7], "aspectRatio": 1.3333},
            "objects": [
                {"type": "cube", "position": [-1.2, 0, 0], "size": [1, 1, 1],
                 "material": {"type": "metal", "color": [0.9, 0.3, 0.3],
                              "roughness": 0.05}},
                {"type": "cube", "position": [1.2, 0.2, -1],
                 "size": [1.2, 1.4, 1.2],
                 "material": {"type": "lambertian",
                              "color": [0.3, 0.3, 0.9]}},
                {"type": "sphere", "position": [0, 0.3, 1.5], "radius": 0.5,
                 "material": {"type": "dielectric",
                              "refractionIndex": 1.5}},
                {"type": "plane", "position": [0, -0.7, 0],
                 "normal": [0, 1, 0],
                 "material": {"type": "lambertian",
                              "color": [0.5, 0.5, 0.45]}},
            ],
            "lights": [
                {"position": [4, 6, 4], "color": [1, 1, 1],
                 "intensity": 50.0},
            ],
        }, dict(max_depth=6, shadow_samples=8)
    if name == "prism_perfectmirror":
        return {
            "camera": {"position": [0, 0.5, 6], "aspectRatio": 1.3333},
            "objects": [
                {"type": "triangularPrism", "vertices": [
                    [-1.0, -0.5, 0.5], [0.0, 1.0, 0.5], [1.0, -0.5, 0.5],
                    [-1.0, -0.5, -0.5], [0.0, 1.0, -0.5],
                    [1.0, -0.5, -0.5]],
                 "material": {"type": "perfectmirror",
                              "color": [0.95, 0.95, 0.98]}},
                {"type": "sphere", "position": [2.2, 0, -1], "radius": 0.6,
                 "material": {"type": "lambertian",
                              "color": [0.8, 0.4, 0.8]}},
                {"type": "sphere", "position": [0, -101, 0], "radius": 100.0,
                 "material": {"type": "lambertian",
                              "color": [0.55, 0.6, 0.5]}},
            ],
            "lights": [
                {"position": [3, 5, 5], "color": [1, 1, 1],
                 "intensity": 45.0},
            ],
        }, dict(max_depth=6, shadow_samples=8)
    if name == "extended_textured":
        return {
            "camera": {"position": [0, 1.0, 7], "aspectRatio": 1.3333},
            "objects": [
                {"type": "sphere", "position": [-1.4, 0.3, 0], "radius": 0.8,
                 "material": {"type": "mirror", "color": [0.95, 0.95, 0.95],
                              "roughness": 0.05}},
                {"type": "sphere", "position": [1.4, 0.3, 0], "radius": 0.8,
                 "material": {"type": "sheen", "color": [0.7, 0.3, 0.3],
                              "sheenColor": [1.0, 0.9, 0.8],
                              "sheenRoughness": 0.3}},
                {"type": "sphere", "position": [0, 0.1, -1.8], "radius": 0.9,
                 "material": {"type": "emission", "color": [0.3, 0.8, 1.0],
                              "intensity": 2.0}},
                {"type": "sphere", "position": [0, -100.5, 0],
                 "radius": 100.0,
                 "material": {"type": "lambertian", "color": [1, 1, 1],
                              "texture": {"type": "checkerboard",
                                          "scale": 0.8,
                                          "color1": [0.85, 0.85, 0.9],
                                          "color2": [0.15, 0.15, 0.2]}}},
            ],
            "lights": [{"position": [4, 6, 5], "color": [1, 0.98, 0.92],
                        "intensity": 55.0}],
        }, dict(max_depth=6, shadow_samples=8)
    if name == "mesh_smooth_icosphere":
        return {
            "camera": {"position": [0, 0.4, 5], "aspectRatio": 1.3333},
            "objects": [
                {"type": "mesh",
                 "path": os.path.abspath(os.path.join(ASSETS,
                                                      "icosphere.obj")),
                 "position": [0, 0.2, 0], "scale": 1.1,
                 "material": {"type": "metal", "color": [0.8, 0.7, 0.5],
                              "roughness": 0.15}},
                {"type": "sphere", "position": [0, -101, 0], "radius": 100.0,
                 "material": {"type": "lambertian",
                              "color": [0.6, 0.6, 0.55]}},
            ],
            "lights": [{"position": [4, 6, 5], "color": [1, 1, 1],
                        "intensity": 45.0}],
        }, dict(max_depth=5, shadow_samples=4)
    raise ValueError(f"unknown golden scene {name!r}")


def grid_scene_dict(side: int = 18):
    """grid-5833, the JAX package's first stream workload
    (tools/tpu_stream_smoke.py:50): an 18^3 grid of radius-0.35 spheres
    (one third each lambertian, metal and glass) over a ground plane, one
    light: 5,833 primitives."""
    objs = [{"type": "plane", "position": [0, -0.5, 0],
             "normal": [0, 1, 0],
             "material": {"type": "lambertian", "color": [0.5, 0.5, 0.5]}}]
    mats = [{"type": "lambertian", "color": [0.8, 0.3, 0.3]},
            {"type": "metal", "color": [0.8, 0.8, 0.9], "roughness": 0.1},
            {"type": "glass", "color": [0.9, 0.9, 0.9]}]
    k = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                objs.append({
                    "type": "sphere",
                    "position": [(ix - side / 2) * 1.2,
                                 iy * 1.2 + 0.2,
                                 (iz - side / 2) * 1.2 - 16.0],
                    "radius": 0.35,
                    "material": mats[k % 3]})
                k += 1
    return {
        "camera": {"position": [0, 6, 18], "aspectRatio": 1.333},
        "objects": objs,
        "lights": [{"type": "point", "position": [10, 30, 20],
                    "color": [1, 1, 1], "intensity": 2.0}],
    }


def grad_grid_scene_dict(side: int = 10):
    """grid-1001, the JAX package's gradient-at-scale scene
    (tools/measure_grad_scale.py:39, tests/test_diff.py:303): a 10^3 grid
    of radius-0.32 spheres (lambertian and metal in turn) over a ground
    plane, one light: 1,001 primitives."""
    objs = [{"type": "plane", "position": [0, -0.6, 0],
             "normal": [0, 1, 0],
             "material": {"type": "lambertian", "color": [0.5, 0.5, 0.5]}}]
    mats = [{"type": "lambertian", "color": [0.8, 0.3, 0.3]},
            {"type": "metal", "color": [0.8, 0.8, 0.9], "roughness": 0.2}]
    for i in range(side ** 3):
        ix, iy, iz = i % side, (i // side) % side, i // side ** 2
        objs.append({"type": "sphere",
                     "position": [(ix - side / 2) * 1.1, iy * 1.1 + 0.2,
                                  (iz - side / 2) * 1.1 - 9.0],
                     "radius": 0.32, "material": mats[i % 2]})
    return {
        "camera": {"position": [0, 3, 9], "aspectRatio": 1.33},
        "objects": objs,
        "lights": [{"type": "point", "position": [6, 20, 12],
                    "color": [1, 1, 1], "intensity": 2.0}],
    }


def diff_scene_dict(name: str):
    """The scenes of the JAX package's gradient tests: "simple"
    (tests/conftest.py:simple_scene_dict, one lambertian sphere and one
    light) and "cube" (tests/test_diff.py:CUBE_SCENE, a glass sphere
    between the camera and a lit cube, so the image depends on the IOR)."""
    if name == "simple":
        return {
            "camera": {"position": [0, 0, 3], "lookAt": [0, 0, 0],
                       "up": [0, 1, 0], "fov": 60, "aspectRatio": 1.0},
            "objects": [
                {"type": "sphere", "position": [0, 0, 0], "radius": 1.0,
                 "material": {"type": "lambertian",
                              "color": [0.5, 0.5, 0.5]}}],
            "lights": [{"type": "point", "position": [0, 5, 5],
                        "color": [1, 1, 1], "intensity": 2.0}],
        }
    if name == "cube":
        return {
            "camera": {"position": [0, 0, 4], "lookAt": [0, 0, 0],
                       "up": [0, 1, 0], "fov": 60, "aspectRatio": 1.5},
            "objects": [
                {"type": "cube", "position": [0, 0, 0],
                 "size": [1.8, 1.8, 1.8],
                 "material": {"type": "lambertian",
                              "color": [0.7, 0.3, 0.3]}},
                {"type": "sphere", "position": [0.2, 0.1, 2.0],
                 "radius": 0.5,
                 "material": {"type": "glass", "color": [0.9, 0.9, 1.0],
                              "refractionIndex": 1.5}}],
            "lights": [{"type": "point", "position": [3, 5, 4],
                        "color": [1, 1, 1], "intensity": 2.0}],
        }
    raise KeyError(f"no gradient scene {name!r}: 'simple' or 'cube'")


def icosphere_obj(subdiv: int = 4) -> str:
    """Midpoint-subdivided unit icosphere OBJ text (20 * 4^subdiv faces)
    with per-vertex normals (the positions on the unit sphere)
    (tools/tpu_stream_smoke.py:83)."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [tuple(v) for v in verts]
    cache = {}

    def mid(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = np.asarray(verts[a]) + np.asarray(verts[b])
            m /= np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(tuple(m))
        return cache[key]

    for _ in range(subdiv):
        nxt = []
        for (a, b, c) in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nxt += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = nxt
    lines = [f"v {v[0]:.9f} {v[1]:.9f} {v[2]:.9f}" for v in verts]
    lines += [f"vn {v[0]:.9f} {v[1]:.9f} {v[2]:.9f}" for v in verts]
    lines += [f"f {a+1}//{a+1} {b+1}//{b+1} {c+1}//{c+1}"
              for (a, b, c) in faces]
    return "\n".join(lines) + "\n"


def mesh_scene_dict(tmpdir: str, subdiv: int = 4):
    """ico-10241, the JAX package's second stream workload
    (tools/tpu_stream_smoke.py:133): two smooth-shaded icosphere meshes
    (2 x 20 * 4^subdiv triangles with vertex normals; 10,240 at subdiv 4)
    over a ground plane, one light. The OBJ is written into ``tmpdir``."""
    path = os.path.join(tmpdir, f"ico{subdiv}.obj")
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(icosphere_obj(subdiv))
    return {
        "camera": {"position": [0, 1, 6], "aspectRatio": 1.333},
        "objects": [
            {"type": "plane", "position": [0, -0.8, 0],
             "normal": [0, 1, 0],
             "material": {"type": "lambertian",
                          "color": [0.5, 0.5, 0.5]}},
            {"type": "mesh", "path": path, "position": [0, 0.6, 0],
             "scale": 1.4, "smooth": True,
             "material": {"type": "metal", "color": [0.8, 0.8, 0.9],
                          "roughness": 0.1}},
            {"type": "mesh", "path": path, "position": [-2.6, 0.4, -1],
             "scale": 1.0, "smooth": True,
             "material": {"type": "lambertian",
                          "color": [0.8, 0.3, 0.3]}},
        ],
        "lights": [{"type": "point", "position": [6, 10, 8],
                    "color": [1, 1, 1], "intensity": 2.0}],
    }
