"""Wavefront OBJ triangle meshes as a scene object type.

Port of ``raytrace_tpu/models/mesh.py`` (pure numpy, so the two give the
same triangles bit for bit): a minimal OBJ parser (``v``/``vn``/``f``
records, fan triangulation, negative indices), the placement transform
(scale, yaw about +Y, translate) for positions and normals, and the
expansion into the scene loader's triangle list. Faces whose three corners
carry a normal index are smooth-shaded (barycentric vertex-normal
interpolation at the hit); ``"smooth": false`` forces flat shading.
"""

from __future__ import annotations

import math
import os
from typing import List, Sequence, Union

import numpy as np

__all__ = ["parse_obj", "load_obj", "place_mesh", "place_normals",
           "mesh_triangles", "mesh_from_dict"]


def parse_obj(text: str, return_normals: bool = False):
    """Parse OBJ source into (vertices [N,3] f64, faces [M,3] i32).

    Supports ``v x y z``, ``vn x y z`` and ``f`` records; face vertices
    may be ``i``, ``i/t``, ``i//n`` or ``i/t/n``, 1-based per the spec,
    with negative indices counting back from the records read so far.
    Polygons with >3 vertices are fan-triangulated around their first
    vertex. Zero-area (repeated-index) triangles are dropped. Everything
    else (vt/vp/o/g/s/usemtl/comments) is ignored.

    With ``return_normals=True`` the result is (vertices, faces,
    normals [K,3] f64, fnormals [M,3] i32) where fnormals carries each
    corner's normal index or -1 where the face token had none — the
    vertex-normal channel NewTriangleWithNormals consumes
    (triangle.go:22-34). Default keeps the historical 2-tuple.
    """
    verts: List[List[float]] = []
    norms: List[List[float]] = []
    faces: List[List[int]] = []
    fnorms: List[List[int]] = []
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            if len(parts) < 4:
                raise ValueError(f"OBJ line {ln}: v needs 3 coordinates")
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "vn":
            if len(parts) < 4:
                raise ValueError(f"OBJ line {ln}: vn needs 3 coordinates")
            norms.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "f":
            if len(parts) < 4:
                raise ValueError(f"OBJ line {ln}: f needs >=3 vertices")
            idx = []
            nidx = []
            for tok in parts[1:]:
                segs = tok.split("/")
                i = int(segs[0])
                if i < 0:
                    i += len(verts)       # -1 = most recent vertex
                else:
                    i -= 1                # OBJ is 1-based
                if not 0 <= i < len(verts):
                    raise ValueError(
                        f"OBJ line {ln}: vertex index {tok} out of range")
                idx.append(i)
                n = -1
                if len(segs) >= 3 and segs[2]:
                    n = int(segs[2])
                    n = n + len(norms) if n < 0 else n - 1
                    if not 0 <= n < len(norms):
                        # Dangling //n with no matching vn record: the
                        # historical parser ignored the normal channel
                        # entirely, so stay lenient - flat-shade the
                        # corner rather than reject the file.
                        n = -1
                nidx.append(n)
            for k in range(1, len(idx) - 1):   # fan triangulation
                a, b, c = idx[0], idx[k], idx[k + 1]
                if a != b and b != c and a != c:
                    faces.append([a, b, c])
                    fnorms.append([nidx[0], nidx[k], nidx[k + 1]])
        # vt/vp/o/g/s/usemtl/mtllib: ignored
    v = np.asarray(verts, np.float64).reshape(len(verts), 3)
    f = np.asarray(faces, np.int32).reshape(len(faces), 3)
    if not return_normals:
        return v, f
    n = np.asarray(norms, np.float64).reshape(len(norms), 3)
    fn = np.asarray(fnorms, np.int32).reshape(len(faces), 3)
    return v, f, n, fn


def load_obj(path: str, return_normals: bool = False):
    """parse_obj over a file (relative paths resolve from the cwd)."""
    with open(path) as fh:
        return parse_obj(fh.read(), return_normals=return_normals)


def place_mesh(verts: np.ndarray,
               position: Sequence[float] = (0.0, 0.0, 0.0),
               scale: Union[float, Sequence[float]] = 1.0,
               rotation_y: float = 0.0) -> np.ndarray:
    """Model -> world: scale, then yaw about +Y (degrees), then translate.

    The same placement fields scene JSON carries for cubes
    (position/size); scale may be a scalar or per-axis [sx, sy, sz].
    """
    v = np.asarray(verts, np.float64)
    s = np.asarray(scale, np.float64)
    v = v * (s if s.shape == (3,) else float(s))
    if rotation_y:
        th = math.radians(float(rotation_y))
        c, sn = math.cos(th), math.sin(th)
        x, y, z = v[:, 0].copy(), v[:, 1], v[:, 2].copy()
        v = np.stack([c * x + sn * z, y, -sn * x + c * z], axis=1)
    return v + np.asarray(position, np.float64)


def place_normals(normals: np.ndarray,
                  scale: Union[float, Sequence[float]] = 1.0,
                  rotation_y: float = 0.0) -> np.ndarray:
    """Model -> world for NORMALS: inverse-transpose of place_mesh's
    linear part. Uniform scale leaves directions alone; per-axis scale
    maps n -> n / s (then renormalized); yaw rotates like positions
    (rotations are their own inverse-transpose). Translation is ignored.
    """
    n = np.asarray(normals, np.float64)
    s = np.asarray(scale, np.float64)
    if s.shape == (3,):
        n = n / s
    if rotation_y:
        th = math.radians(float(rotation_y))
        c, sn = math.cos(th), math.sin(th)
        x, y, z = n[:, 0].copy(), n[:, 1], n[:, 2].copy()
        n = np.stack([c * x + sn * z, y, -sn * x + c * z], axis=1)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.where(ln > 0, ln, 1.0)


def mesh_triangles(verts: np.ndarray, faces: np.ndarray,
                   normals: np.ndarray = None, fnormals: np.ndarray = None):
    """Triangle list in the scene loader's add_tris shape.

    Flat faces yield (v0, v1, v2); faces whose three corners all carry a
    normal index yield (v0, v1, v2, (n0, n1, n2)) — the smooth-shaded
    form (NewTriangleWithNormals, triangle.go:22-34). A face with only
    partial normal data falls back to flat, matching the reference's
    all-or-nothing constructor.
    """
    v = np.asarray(verts, np.float64)
    if normals is None or fnormals is None or len(normals) == 0:
        return [(v[a], v[b], v[c]) for a, b, c in np.asarray(faces)]
    n = np.asarray(normals, np.float64)
    out = []
    for (a, b, c), (na, nb, nc) in zip(np.asarray(faces),
                                       np.asarray(fnormals)):
        if na >= 0 and nb >= 0 and nc >= 0:
            out.append((v[a], v[b], v[c], (n[na], n[nb], n[nc])))
        else:
            out.append((v[a], v[b], v[c]))
    return out


def mesh_from_dict(obj: dict, base_dir: str = "."):
    """Triangle list for a scene-JSON mesh object.

    Schema: ``{"type": "mesh", "path": "model.obj", "position": [...],
    "scale": s | [sx,sy,sz], "rotationY": deg, "material": {...},
    "smooth": true}``. OBJ ``vn`` records with ``i//n`` faces produce
    smooth-shaded triangles (barycentric normal interpolation at hit
    time); ``"smooth": false`` forces flat shading even when the file
    carries normals. The Go loader would silently skip the unknown type
    (scene.go:80-83), so --go-parity mode drops it; see scene.from_dict.
    """
    path = obj.get("path")
    if not path:
        raise ValueError("mesh object needs a 'path' to an OBJ file")
    if not os.path.isabs(path):
        path = os.path.join(base_dir, path)
    verts, faces, norms, fnorms = load_obj(path, return_normals=True)
    scale = obj.get("scale", 1.0)
    rot = float(obj.get("rotationY", 0.0))
    verts = place_mesh(verts, position=obj.get("position", (0.0, 0.0, 0.0)),
                       scale=scale, rotation_y=rot)
    if not obj.get("smooth", True):
        norms, fnorms = None, None
    elif len(norms):
        norms = place_normals(norms, scale=scale, rotation_y=rot)
    return mesh_triangles(verts, faces, norms, fnorms)
