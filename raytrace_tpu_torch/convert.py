"""Carry a packed scene across from the JAX package.

A ray tracer has no weights: its state is the packed scene. The JAX
package's ``Scene`` is a pytree of arrays; ``scene_from_numpy`` takes those
leaves as numpy arrays, grouped by table, and builds the port's ``Scene``
from them unchanged, so both packages can trace the very same tables: the
vertex normals, the extended-kind columns, the texture bindings and the
scene BVH (``Scene.accel``) included, with a stream-mode scene's unified
leaf rows (``accel["stream_tab"]``). ``params_from_numpy`` carries the
differentiable parameters of the JAX package's ``diff.split_params`` (or
a ``TrainState.params``) across as the port's ``diff`` dict. This module
does not import the JAX package: the caller hands over numpy, and texture
bindings as plain data.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _device
from . import bvh as bvh_mod
from . import scene as scene_mod
from .models import materials as mat_mod
from .models import textures as tex_mod

# The texture classes by name: the JAX package's names are the port's.
TEXTURES = {cls.__name__: cls for cls in tex_mod.TEX_TYPE}


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    elif arr.dtype.kind in "iu":
        arr = arr.astype(np.int32)
    # np.array, not np.ascontiguousarray, which makes a 0-d array 1-d
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def _tensors(cls, leaves: Mapping[str, np.ndarray], device, **extra):
    kw = {f.name: _tensor(leaves[f.name], device)
          for f in dataclasses.fields(cls)
          if f.name not in extra and f.default is dataclasses.MISSING}
    return cls(**kw, **extra)


def _texture(kind: str, fields: Mapping[str, Any]):
    cls = TEXTURES[kind]
    return cls(**{k: tuple(v) if isinstance(v, (list, tuple)) else v
                  for k, v in fields.items()})


def scene_from_numpy(camera: Mapping[str, np.ndarray],
                     geometry: Mapping[str, np.ndarray],
                     materials: Mapping[str, np.ndarray],
                     lights: Mapping[str, np.ndarray], *,
                     occl_tris: int = -1, sph_count: int = 0,
                     mesh_count: int = 0,
                     accel: Optional[Mapping[str, np.ndarray]] = None,
                     textures: Sequence[Tuple[int, str, Mapping]] = (),
                     device=None) -> scene_mod.Scene:
    """Build the port's Scene from numpy tables.

    Each mapping holds the fields of the matching dataclass
    (``scene.Camera``, ``scene.Geometry``, ``materials.MaterialTable``,
    ``scene.Lights``, and for ``accel`` ``bvh.FlatBVH``, ``leaf_size``
    included) under the JAX package's field names. ``geometry`` may hold
    ``tri_vn`` ((Nt,9), or None for a flat scene); ``materials`` may hold
    the ``aux_vec``/``aux_a``/``aux_b`` columns and ``has_advanced``.
    ``textures`` lists the texture bindings as (material index, texture
    class name, {field: value}). ``accel`` may hold ``stream_tab``, the JAX
    package's stream table (its rows padded to 128 columns): its first 14
    (23 with vertex normals) columns become the port's, and they must equal
    the port's own ``megakernel.pack_stream_table`` of the scene, or
    ValueError. The 4-wide view is not carried: the port widens the
    carried tree itself (``bvh.widen4``, the JAX package's ``widen4``
    table for the same tree), so extra keys are ignored.
    """
    device = _device.resolve(device)
    tree = None
    if accel is not None:
        tree = bvh_mod.with_wide4(_tensors(
            bvh_mod.FlatBVH, accel, device,
            leaf_size=int(accel["leaf_size"])))
    vn = geometry.get("tri_vn")
    mats = dict(materials)
    n_mat = np.asarray(mats["kind"]).shape[0]
    for name, shape in (("aux_vec", (n_mat, 3)), ("aux_a", (n_mat,)),
                        ("aux_b", (n_mat,))):
        if name not in mats or np.asarray(mats[name]).shape != shape:
            mats[name] = np.zeros(shape, np.float32)
    scene = scene_mod.Scene(
        camera=_tensors(scene_mod.Camera, camera, device),
        geometry=_tensors(scene_mod.Geometry, geometry, device,
                          occl_tris=int(occl_tris),
                          tri_vn=None if vn is None else _tensor(vn, device)),
        materials=_tensors(
            mat_mod.MaterialTable, mats, device,
            has_advanced=bool(mats.get("has_advanced", False)),
            textures=tuple((int(mi), _texture(kind, fields))
                           for mi, kind, fields in textures)),
        lights=_tensors(scene_mod.Lights, lights, device),
        sph_count=int(sph_count), mesh_count=int(mesh_count), accel=tree)
    tab = None if accel is None else accel.get("stream_tab")
    if tab is None:
        return scene
    from .ops import megakernel
    own = megakernel.pack_stream_table(scene)
    got = _tensor(np.asarray(tab)[:, :own.shape[1]], device)
    if not torch.equal(got, own):
        raise ValueError("the JAX scene's stream table differs from the "
                         "port's pack_stream_table of the same scene")
    return dataclasses.replace(scene, accel=dataclasses.replace(
        tree, stream_tab=got))


def params_from_numpy(params: Mapping[str, Mapping[str, np.ndarray]],
                      device=None) -> dict:
    """The port's ``diff`` parameter dict ({group: {field: float32
    tensor}}) from the JAX package's ``diff.split_params`` dict or
    ``TrainState.params``, its leaves as numpy arrays. Every field of
    ``diff.DIFF_FIELDS`` must be there (KeyError otherwise); other keys
    are ignored."""
    from .diff import DIFF_FIELDS
    device = _device.resolve(device)
    return {group: {f: _tensor(params[group][f], device) for f in fields}
            for group, fields in DIFF_FIELDS.items()}
