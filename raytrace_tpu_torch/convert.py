"""Carry a packed scene across from the JAX package.

A ray tracer has no weights: its state is the packed scene. The JAX
package's ``Scene`` is a pytree of arrays; ``scene_from_numpy`` takes those
leaves as numpy arrays, grouped by table, and builds the port's ``Scene``
from them unchanged, so both packages can trace the very same tables,
the scene BVH (``Scene.accel``) included. This module does not import the
JAX package: the caller hands over numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from . import _device
from . import bvh as bvh_mod
from . import scene as scene_mod
from .models import materials as mat_mod


def _tensors(cls, leaves: Mapping[str, np.ndarray], device, **extra):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in extra:
            continue
        arr = np.asarray(leaves[f.name])
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        elif arr.dtype.kind in "iu":
            arr = arr.astype(np.int32)
        kw[f.name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return cls(**kw, **extra)


def scene_from_numpy(camera: Mapping[str, np.ndarray],
                     geometry: Mapping[str, np.ndarray],
                     materials: Mapping[str, np.ndarray],
                     lights: Mapping[str, np.ndarray], *,
                     occl_tris: int = -1, sph_count: int = 0,
                     mesh_count: int = 0,
                     accel: Optional[Mapping[str, np.ndarray]] = None,
                     device=None) -> scene_mod.Scene:
    """Build the port's Scene from numpy tables.

    Each mapping holds the fields of the matching dataclass
    (``scene.Camera``, ``scene.Geometry``, ``materials.MaterialTable``,
    ``scene.Lights``, and for ``accel`` ``bvh.FlatBVH``, ``leaf_size``
    included) under the JAX package's field names; extra keys (textures,
    vertex normals, the 4-wide tree) are ignored.
    """
    device = _device.resolve(device)
    tree = None
    if accel is not None:
        tree = _tensors(bvh_mod.FlatBVH, accel, device,
                        leaf_size=int(accel["leaf_size"]))
    return scene_mod.Scene(
        camera=_tensors(scene_mod.Camera, camera, device),
        geometry=_tensors(scene_mod.Geometry, geometry, device,
                          occl_tris=int(occl_tris)),
        materials=_tensors(mat_mod.MaterialTable, materials, device),
        lights=_tensors(scene_mod.Lights, lights, device),
        sph_count=int(sph_count), mesh_count=int(mesh_count), accel=tree)
