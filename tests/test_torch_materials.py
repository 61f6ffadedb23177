"""The port's material table and scatter against
raytrace_tpu.models.materials, the extended kinds (7-12) included.

* Rows: material_row and build_table for every kind and its parameters
  (aux_vec, aux_a, aux_b, has_advanced, the texture binding) equal the JAX
  package's exactly: both cast the same float64 values to float32.
* Scatter: 4,096 seeded lanes over a table of all thirteen kinds (normals,
  ray directions, front faces, unit-ball samples and dielectric picks
  made with numpy); directions and attenuations within 1e-6 of the JAX
  package's, did_scatter equal. Both run the same float32 operations;
  XLA may reorder the three-term dot products by an ulp.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu.models import materials as jmat
from raytrace_tpu_torch.models import materials as tmat

MATERIALS = [
    {"type": "lambertian", "color": [0.8, 0.3, 0.3]},
    {"type": "metal", "color": [0.8, 0.8, 0.9], "roughness": 0.1},
    {"type": "shiny", "color": [0.55, 0.2, 0.8], "roughness": 0.15,
     "specular": 0.9},
    {"type": "perfectmirror", "color": [0.92, 0.92, 0.95]},
    {"type": "glass", "color": [0.9, 0.9, 0.9], "refractionIndex": 1.7},
    {"type": "dielectric", "refractionIndex": 1.4},
    {"type": "diffuselight", "color": [2, 1.5, 1]},
    {"type": "subsurface", "color": [0.9, 0.6, 0.5],
     "absorption": [0.8, 0.5, 0.3], "scatteringRadius": 0.7,
     "phaseFunction": 0.4},
    {"type": "anisotropic", "color": [0.7, 0.7, 0.8], "roughness": 0.3,
     "anisotropy": 0.6, "direction": [0.0, 1.0, 0.2]},
    {"type": "clearcoat", "color": [0.2, 0.4, 0.8], "strength": 0.7,
     "clearcoatIOR": 1.6, "clearcoatRoughness": 0.05},
    {"type": "sheen", "color": [0.7, 0.3, 0.3], "sheenColor": [1, 0.9, 0.8],
     "sheenRoughness": 0.3, "sheenTint": 0.25},
    {"type": "emission", "color": [0.3, 0.8, 1.0], "intensity": 2.0,
     "emissionType": "directional", "falloff": 0.5},
    {"type": "mirror", "color": [0.95, 0.95, 0.98], "roughness": 0.4},
    {"type": "lambertian", "color": [1, 1, 1],
     "texture": {"type": "marble", "scale": 2.0}},
]
FIELDS = ("kind", "albedo", "roughness", "metallic", "specular", "ior",
          "emit", "eff_albedo", "aux_vec", "aux_a", "aux_b")


def tables():
    jrows = [jmat.material_row(m) for m in MATERIALS]
    trows = [tmat.material_row(m) for m in MATERIALS]
    return jmat.build_table(jrows), tmat.build_table(trows), jrows, trows


def test_rows_equal():
    jt, tt, jrows, trows = tables()
    for j, t in zip(jrows, trows):
        assert {k: v for k, v in j.items() if k != "texture"} == {
            k: v for k, v in t.items() if k != "texture"}
        assert ("texture" in j) == ("texture" in t)
    for name in FIELDS:
        got = getattr(tt, name)
        assert got.dtype in (torch.float32, torch.int32), name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    assert tt.has_advanced == jt.has_advanced is True
    assert [(i, type(x).__name__, dataclasses.asdict(x))
            for i, x in tt.textures] == [
        (i, type(x).__name__, dataclasses.asdict(x)) for i, x in jt.textures]


def test_go_parity_rows_fall_back():
    for m in MATERIALS[7:]:
        j = jmat.material_row(m, extended=False)
        t = tmat.material_row(m, extended=False)
        assert t == j and t["kind"] == tmat.LAMBERTIAN and "texture" not in t


def lanes(n, nm, seed=0):
    r = np.random.default_rng(seed)
    mid = np.arange(n) % nm
    nrm = r.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = r.normal(size=(n, 3)) * r.uniform(0.5, 2.0, (n, 1))
    front = r.uniform(size=n) < 0.7
    ball = r.normal(size=(n, 3))
    ball *= (r.uniform(size=(n, 1)) ** (1 / 3)
             / np.linalg.norm(ball, axis=1, keepdims=True))
    pick = r.uniform(size=n)
    f = lambda a: a.astype(np.float32)
    return mid, f(d), f(nrm), front, f(ball), f(pick)


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_matches_jax(seed):
    jt, tt, _, _ = tables()
    mid, d, nrm, front, ball, pick = lanes(4096, len(MATERIALS), seed)
    jdir, jatt, jsc = (np.asarray(a) for a in jmat.scatter(
        jt.row(jnp.asarray(mid)), jnp.asarray(d), jnp.asarray(nrm),
        jnp.asarray(front), jnp.asarray(ball), jnp.asarray(pick)))
    tdir, tatt, tsc = (a.numpy() for a in tmat.scatter(
        tt.row(torch.from_numpy(mid)), torch.from_numpy(d),
        torch.from_numpy(nrm), torch.from_numpy(front),
        torch.from_numpy(ball), torch.from_numpy(pick)))
    np.testing.assert_array_equal(tsc, jsc)
    # every kind takes both verdicts somewhere, or its fixed one
    kinds = np.asarray(jt.kind)[mid]
    for k, fixed in ((tmat.DIFFUSE_LIGHT, False), (tmat.EMISSION, False),
                     (tmat.LAMBERTIAN, True)):
        assert (tsc[kinds == k] == fixed).all()
    assert tsc[kinds == tmat.MIRROR].any() and (~tsc[kinds ==
                                                    tmat.MIRROR]).any()
    live = jsc  # a lane that does not scatter never reads its direction
    np.testing.assert_allclose(tdir[live], jdir[live], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tatt[live], jatt[live], rtol=0, atol=1e-6)
