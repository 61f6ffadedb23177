"""Scene schema and loader: JSON -> dataclasses of tensors.

Port of ``raytrace_tpu/scene.py`` for spheres, cubes, triangular prisms,
OBJ meshes (``models/mesh.py``), planes and point lights. Geometry is
struct-of-arrays: spheres as
(center, radius, mat), every triangle in one flat table, planes, and cubes
as axis-aligned boxes plus their 12 inward-wound face triangles, which are
ordered last (``Geometry.occl_tris``): the boxes are the hit form, the
faces serve only the conservative pixel mask. A scene with a smooth-shaded
mesh carries per-vertex normals for every triangle (``Geometry.tri_vn``).

Values go float64 -> float32 through numpy, the cast order of the JAX
loader, so the tables equal the JAX package's bit for bit. Scenes of at
least ``bvh.BVH_THRESHOLD`` spheres and triangles get a scene BVH
(``Scene.accel``) at load, built from the same float32 values, so the tree
equals the JAX package's too; smooth-shaded scenes get one from
``UNROLL_PRIM_LIMIT_VN`` primitives on, as there. Past
``MAX_BVH_KERNEL_PRIMS`` primitives the accel also carries the stream
table (``_attach_stream_table``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import _device
from . import bvh as bvh_mod
from .models import materials as mat_mod
from .models import mesh as mesh_mod

# Past this many primitives (spheres + triangles + planes) a scene with a
# BVH runs stream mode (K5: the walk reads unified leaf rows,
# Scene.accel.stream_tab); the tree's leaf size grows there
# (_accel_leaf_size).
MAX_BVH_KERNEL_PRIMS = 4096
# Smooth-shaded scenes leave unroll mode past this many primitives in the
# JAX package (megakernel.UNROLL_PRIM_LIMIT_VN), and from_dict gives them
# a BVH past it so that they run bvh mode, not loop mode.
UNROLL_PRIM_LIMIT_VN = 48


def _replace_device(obj, device):
    return type(obj)(**{
        f.name: (getattr(obj, f.name).to(device)
                 if isinstance(getattr(obj, f.name), torch.Tensor)
                 else getattr(obj, f.name))
        for f in dataclasses.fields(obj)})


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor      # (3,)
    look_at: torch.Tensor       # (3,)
    up: torch.Tensor            # (3,)
    fov: torch.Tensor           # ()
    aspect_ratio: torch.Tensor  # ()

    def to(self, device) -> "Camera":
        return _replace_device(self, device)


@dataclasses.dataclass(frozen=True)
class Geometry:
    sph_center: torch.Tensor  # (Ns,3)
    sph_radius: torch.Tensor  # (Ns,)
    sph_mat: torch.Tensor     # (Ns,) int32
    tri_v0: torch.Tensor      # (Nt,3)
    tri_v1: torch.Tensor      # (Nt,3)
    tri_v2: torch.Tensor      # (Nt,3)
    tri_normal: torch.Tensor  # (Nt,3) unit face normal
    tri_mat: torch.Tensor     # (Nt,) int32
    pl_point: torch.Tensor    # (Np,3)
    pl_normal: torch.Tensor   # (Np,3)
    pl_mat: torch.Tensor      # (Np,) int32
    box_min: torch.Tensor     # (Nb,3)
    box_max: torch.Tensor     # (Nb,3)
    box_mat: torch.Tensor     # (Nb,) int32
    # Triangles [0, occl_tris) take part in hit tests; [occl_tris, Nt) are
    # cube faces covered by the boxes. -1: no boxes, all triangles.
    occl_tris: int = -1
    # (Nt,9) per-vertex normals [n0.xyz, n1.xyz, n2.xyz], interpolated at
    # the hit, or None (flat shading). Flat triangles of a smooth scene
    # carry their face normal in all three slots.
    tri_vn: Optional[torch.Tensor] = None

    def to(self, device) -> "Geometry":
        return _replace_device(self, device)

    @property
    def n_hit_tris(self) -> int:
        nt = self.tri_v0.shape[0]
        return nt if self.occl_tris < 0 else self.occl_tris


@dataclasses.dataclass(frozen=True)
class Lights:
    position: torch.Tensor   # (L,3)
    color: torch.Tensor      # (L,3)
    intensity: torch.Tensor  # (L,)

    def to(self, device) -> "Lights":
        return _replace_device(self, device)


@dataclasses.dataclass(frozen=True)
class Scene:
    camera: Camera
    geometry: Geometry
    materials: mat_mod.MaterialTable
    lights: Lights
    sph_count: int = 0
    mesh_count: int = 0
    # Scene BVH over the spheres and triangles (bvh.FlatBVH), or None.
    # from_dict attaches it from bvh.BVH_THRESHOLD primitives on.
    accel: Optional[bvh_mod.FlatBVH] = None

    @property
    def device(self) -> torch.device:
        return self.geometry.sph_center.device

    @property
    def num_objects(self) -> int:
        return int(self.sph_count + self.mesh_count)

    @property
    def prim_count(self) -> int:
        """Spheres + triangles + planes: the count the kernel mode keys on."""
        g = self.geometry
        return int(g.sph_center.shape[0] + g.tri_v0.shape[0]
                   + g.pl_point.shape[0])

    def to(self, device) -> "Scene":
        if torch.device(device) == self.device:
            return self
        return dataclasses.replace(
            self, camera=self.camera.to(device),
            geometry=self.geometry.to(device),
            materials=self.materials.to(device),
            lights=self.lights.to(device),
            accel=None if self.accel is None else self.accel.to(device))


def _accel_leaf_size(n: int) -> int:
    """Leaf size by scene scale (n = spheres + triangles + planes):
    LEAF_SIZE_DEFAULT up to MAX_BVH_KERNEL_PRIMS; past it the leaves grow
    so the stream kernel's node table stays near 400 KB, as in the JAX
    package."""
    if n <= MAX_BVH_KERNEL_PRIMS:
        return bvh_mod.LEAF_SIZE_DEFAULT
    leaf = 32
    while leaf < 512 and (4 * n // leaf) * 36 > 400_000:
        leaf *= 2
    return leaf


def with_accel(scene: Scene, leaf_size: Optional[int] = None) -> Scene:
    """The scene with a freshly built sphere+triangle BVH attached
    (``leaf_size`` defaults to the _accel_leaf_size policy)."""
    g = scene.geometry
    n = g.sph_center.shape[0] + g.tri_v0.shape[0]
    if n == 0:
        return scene
    if leaf_size is None:
        leaf_size = _accel_leaf_size(n + g.pl_point.shape[0])
    return _attach_stream_table(dataclasses.replace(
        scene, accel=bvh_mod.build_scene_bvh(g, leaf_size)))


def _attach_stream_table(scene: Scene) -> Scene:
    """A stream-mode scene (a BVH and more than
    megakernel.MAX_BVH_KERNEL_PRIMS primitives, as the JAX package reads
    it) with its unified primitive rows packed once, at build
    time (megakernel.pack_stream_table), on the accel; other scenes as
    they are."""
    from .ops import megakernel
    if (scene.accel is None
            or scene.prim_count <= megakernel.MAX_BVH_KERNEL_PRIMS):
        return scene
    return megakernel.with_stream_table(scene)


@dataclasses.dataclass
class SceneConfig:
    """Host-side blocks of the scene JSON that the reference loader drops."""

    renderer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    atmospheric: Dict[str, Any] = dataclasses.field(default_factory=dict)
    volumetric: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fog: Dict[str, Any] = dataclasses.field(default_factory=dict)
    effects: Dict[str, Any] = dataclasses.field(default_factory=dict)
    name: str = "demo_scene"


def _vec3(v, default=(0.0, 0.0, 0.0)) -> List[float]:
    if v is None:
        return list(default)
    if isinstance(v, dict):
        return [float(v.get("X", 0)), float(v.get("Y", 0)),
                float(v.get("Z", 0))]
    return [float(v[0]), float(v[1]), float(v[2])]


def _cube_triangles(position, size):
    """Cube -> 12 triangles in the vertex and face order of the reference
    (all faces wound inward)."""
    px, py, pz = position
    hx, hy, hz = size[0] / 2.0, size[1] / 2.0, size[2] / 2.0
    verts = np.array([
        [px - hx, py - hy, pz - hz], [px + hx, py - hy, pz - hz],
        [px + hx, py + hy, pz - hz], [px - hx, py + hy, pz - hz],
        [px - hx, py - hy, pz + hz], [px + hx, py - hy, pz + hz],
        [px + hx, py + hy, pz + hz], [px - hx, py + hy, pz + hz],
    ])
    faces = [[0, 1, 2, 3], [1, 5, 6, 2], [5, 4, 7, 6],
             [4, 0, 3, 7], [3, 2, 6, 7], [4, 5, 1, 0]]
    tris = []
    for f in faces:
        v0, v1, v2, v3 = (verts[i] for i in f)
        tris.append((v0, v1, v2))
        tris.append((v0, v2, v3))
    return tris


def _prism_triangles(vertices):
    """Triangular prism (front face 0-2, back face 3-5) -> 8 triangles."""
    v = [np.asarray(_vec3(p)) for p in vertices]
    return [
        (v[0], v[1], v[2]), (v[3], v[5], v[4]),
        (v[0], v[3], v[4]), (v[0], v[4], v[1]),
        (v[1], v[4], v[5]), (v[1], v[5], v[2]),
        (v[2], v[5], v[3]), (v[2], v[3], v[0]),
    ]


def _face_normal(v0, v1, v2):
    n = np.cross(v1 - v0, v2 - v0)
    ln = np.linalg.norm(n)
    return n / ln if ln > 0 else n


def _f32(x, shape, device) -> torch.Tensor:
    return torch.from_numpy(
        np.array(x, np.float64).reshape(shape).astype(np.float32)).to(device)


def _i32(x, n, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.int32).reshape(n)).to(device)


def from_dict(data: Dict[str, Any], go_parity: bool = False, device=None,
              build_accel: Optional[bool] = None, base_dir: str = "."):
    """Build (Scene, SceneConfig) from a parsed scene dict.

    go_parity=True reproduces the reference loader: prisms, meshes and
    planes are skipped, extended material kinds fall back to lambertian
    and textures are ignored. The tables are made on ``device`` (default
    CUDA, see ``_device.resolve``). build_accel: attach a scene BVH; None
    builds one from bvh.BVH_THRESHOLD spheres + triangles on, or for a
    smooth-shaded scene past UNROLL_PRIM_LIMIT_VN primitives, as the JAX
    loader does. base_dir resolves relative mesh paths; ``load`` passes
    the scene file's directory.
    """
    device = _device.resolve(device)
    cam_d = data.get("camera", {})

    def cam_t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    camera = Camera(
        position=cam_t(_vec3(cam_d.get("position"))),
        look_at=cam_t(_vec3(cam_d.get("lookAt"))),
        up=cam_t(_vec3(cam_d.get("up"), (0, 1, 0))),
        fov=cam_t(float(cam_d.get("fov", 60.0))),
        aspect_ratio=cam_t(float(cam_d.get("aspectRatio", 1.0))),
    )

    mat_rows: list = []
    mat_index: Dict[tuple, int] = {}
    sph_c, sph_r, sph_m = [], [], []
    tri_v0, tri_v1, tri_v2, tri_n, tri_m = [], [], [], [], []
    tri_vn: list = []  # per triangle (n0, n1, n2), or None (flat)
    cub_v0, cub_v1, cub_v2, cub_n, cub_m = [], [], [], [], []
    box_lo, box_hi, box_m = [], [], []
    pl_p, pl_n, pl_m = [], [], []
    sph_count = mesh_count = 0

    def add_material(mdata) -> int:
        row = mat_mod.material_row(mdata or {"type": "lambertian"},
                                   extended=not go_parity)
        key = mat_mod.row_key(row)
        if key not in mat_index:
            mat_index[key] = len(mat_rows)
            mat_rows.append(row)
        return mat_index[key]

    def face_normal(v0, v1, v2):
        return _face_normal(np.asarray(v0, np.float64),
                            np.asarray(v1, np.float64),
                            np.asarray(v2, np.float64))

    def add_tris(tris, mid):
        # (v0, v1, v2) flat, or (v0, v1, v2, (n0, n1, n2)) smooth
        for item in tris:
            v0, v1, v2 = item[0], item[1], item[2]
            tri_v0.append(v0)
            tri_v1.append(v1)
            tri_v2.append(v2)
            tri_n.append(face_normal(v0, v1, v2))
            tri_vn.append(item[3] if len(item) > 3 else None)
            tri_m.append(mid)

    for obj in data.get("objects", []):
        otype = str(obj.get("type", "")).lower()
        if otype == "sphere":
            mid = add_material(obj.get("material"))
            sph_c.append(_vec3(obj.get("position")))
            sph_r.append(float(obj.get("radius", 1.0)))
            sph_m.append(mid)
            sph_count += 1
        elif otype == "cube":
            mid = add_material(obj.get("material"))
            pos = _vec3(obj.get("position"))
            size = _vec3(obj.get("size"), (1, 1, 1))
            for v0, v1, v2 in _cube_triangles(pos, size):
                cub_v0.append(v0)
                cub_v1.append(v1)
                cub_v2.append(v2)
                cub_n.append(face_normal(v0, v1, v2))
                cub_m.append(mid)
            box_lo.append([pos[k] - size[k] / 2.0 for k in range(3)])
            box_hi.append([pos[k] + size[k] / 2.0 for k in range(3)])
            box_m.append(mid)
            mesh_count += 1
        elif otype == "triangularprism" and not go_parity:
            mid = add_material(obj.get("material"))
            add_tris(_prism_triangles(obj.get("vertices", [])), mid)
            mesh_count += 1
        elif otype == "mesh" and not go_parity:
            mid = add_material(obj.get("material"))
            add_tris(mesh_mod.mesh_from_dict(obj, base_dir), mid)
            mesh_count += 1
        elif otype == "plane" and not go_parity:
            mid = add_material(obj.get("material"))
            pl_p.append(_vec3(obj.get("position")))
            n = np.asarray(_vec3(obj.get("normal"), (0, 1, 0)), np.float64)
            ln = np.linalg.norm(n)
            pl_n.append((n / ln if ln > 0 else n).tolist())
            pl_m.append(mid)
            mesh_count += 1

    lights_d = data.get("lights", [])
    l_pos = [_vec3(lt.get("position")) for lt in lights_d]
    l_col = [_vec3(lt.get("color"), (1, 1, 1)) for lt in lights_d]
    l_int = [float(lt.get("intensity", 1.0)) for lt in lights_d]

    n_occl = len(tri_v0) if box_lo else -1
    tri_v0 += cub_v0
    tri_v1 += cub_v1
    tri_v2 += cub_v2
    tri_n += cub_n
    tri_m += cub_m
    tri_vn += [None] * len(cub_v0)

    ns, nt, nl, npl, nb = (len(sph_c), len(tri_v0), len(l_pos), len(pl_p),
                           len(box_lo))
    vn = None
    if any(v is not None for v in tri_vn):
        vn = _f32([np.tile(np.asarray(tri_n[k], np.float64), 3) if v is None
                   else np.concatenate([np.asarray(v[j], np.float64)
                                        for j in range(3)])
                   for k, v in enumerate(tri_vn)], (nt, 9), device)
    geometry = Geometry(
        sph_center=_f32(sph_c, (ns, 3), device),
        sph_radius=_f32(sph_r, (ns,), device),
        sph_mat=_i32(sph_m, ns, device),
        tri_v0=_f32(tri_v0, (nt, 3), device),
        tri_v1=_f32(tri_v1, (nt, 3), device),
        tri_v2=_f32(tri_v2, (nt, 3), device),
        tri_normal=_f32(tri_n, (nt, 3), device),
        tri_mat=_i32(tri_m, nt, device),
        pl_point=_f32(pl_p, (npl, 3), device),
        pl_normal=_f32(pl_n, (npl, 3), device),
        pl_mat=_i32(pl_m, npl, device),
        box_min=_f32(box_lo, (nb, 3), device),
        box_max=_f32(box_hi, (nb, 3), device),
        box_mat=_i32(box_m, nb, device),
        occl_tris=n_occl,
        tri_vn=vn,
    )
    lights = Lights(position=_f32(l_pos, (nl, 3), device),
                    color=_f32(l_col, (nl, 3), device),
                    intensity=_f32(l_int, (nl,), device))
    scene = Scene(camera=camera, geometry=geometry,
                  materials=mat_mod.build_table(mat_rows, device),
                  lights=lights, sph_count=sph_count, mesh_count=mesh_count)
    if build_accel is None:
        build_accel = ns + nt >= bvh_mod.BVH_THRESHOLD or (
            vn is not None and ns + nt + npl > UNROLL_PRIM_LIMIT_VN)
    if build_accel:
        scene = with_accel(scene)
    cfg = SceneConfig(
        renderer=data.get("renderer", {}) or {},
        atmospheric=data.get("atmospheric", {}) or {},
        volumetric=data.get("volumetric", {}) or {},
        fog=data.get("fog", {}) or {},
        effects={k: data.get(k, {}) or {} for k in
                 ("motionBlur", "depthOfField", "lensFlare", "bloom",
                  "chromaticAberration", "vignette")},
    )
    return scene, cfg


def load(path: str, go_parity: bool = False, device=None,
         build_accel: Optional[bool] = None):
    """Load a scene JSON file (LoadFromFile); mesh paths resolve against
    the file's directory."""
    with open(path) as f:
        data = json.load(f)
    return from_dict(data, go_parity=go_parity, device=device,
                     build_accel=build_accel,
                     base_dir=os.path.dirname(os.path.abspath(path)))
