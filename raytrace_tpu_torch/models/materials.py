"""Material table and vectorised scatter.

Port of ``raytrace_tpu/models/materials.py``. Each material is a row of a
struct-of-arrays table; ``scatter`` evaluates every kind with masked
selects: the seven live kinds (0-6) and the six extended kinds (7-12,
advanced_materials.go in the reference), whose parameters sit in the
``aux_vec``/``aux_a``/``aux_b`` columns. A material may carry a procedural
texture (``models/textures.py``); the table lists those bindings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .._f32 import sqrt as _sqrt
from . import textures as tex_mod

LAMBERTIAN = 0
METAL = 1
SHINY = 2
PERFECT_MIRROR = 3
GLASS = 4
DIELECTRIC = 5
DIFFUSE_LIGHT = 6
SUBSURFACE = 7
ANISOTROPIC = 8
CLEARCOAT = 9
SHEEN = 10
EMISSION = 11        # point / directional / area (aux_a)
MIRROR = 12          # scatters only while the reflection stays above

KIND_NAMES = {
    "lambertian": LAMBERTIAN,
    "metal": METAL,
    "shiny": SHINY,
    "perfectmirror": PERFECT_MIRROR,
    "glass": GLASS,
    "dielectric": DIELECTRIC,
    "diffuselight": DIFFUSE_LIGHT,
}

EXTENDED_KIND_NAMES = {
    **KIND_NAMES,
    "subsurface": SUBSURFACE,
    "anisotropic": ANISOTROPIC,
    "clearcoat": CLEARCOAT,
    "sheen": SHEEN,
    "emission": EMISSION,
    "mirror": MIRROR,
}

EMISSION_POINT, EMISSION_DIRECTIONAL, EMISSION_AREA = 0.0, 1.0, 2.0


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """One row per scene material, float32 except ``kind`` (int32)."""

    kind: torch.Tensor        # (M,)
    albedo: torch.Tensor      # (M,3) raw color
    roughness: torch.Tensor   # (M,)
    metallic: torch.Tensor    # (M,) effective GetMetallic()
    specular: torch.Tensor    # (M,) effective GetSpecular()
    ior: torch.Tensor         # (M,)
    emit: torch.Tensor        # (M,3)
    eff_albedo: torch.Tensor  # (M,3) effective GetAlbedo()
    # Extended-kind parameters (zeros for the live seven): (M,3) SSS
    # absorption / anisotropy direction / sheen color; (M,) SSS radius /
    # anisotropy / clearcoat strength / sheen roughness / emission mode;
    # (M,) SSS phase / clearcoat roughness / sheen tint / emission falloff.
    aux_vec: torch.Tensor
    aux_a: torch.Tensor
    aux_b: torch.Tensor
    # True when any extended kind is present (turns on their branches).
    has_advanced: bool = False
    # ((material index, texture), ...): procedural-texture bindings.
    textures: tuple = ()

    def to(self, device) -> "MaterialTable":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def row(self, idx: torch.Tensor) -> Dict[str, Any]:
        """Per-lane material parameters for material ids ``idx`` (and the
        table's ``has_advanced``)."""
        out = {f.name: getattr(self, f.name)[idx]
               for f in dataclasses.fields(self)
               if isinstance(getattr(self, f.name), torch.Tensor)}
        out["has_advanced"] = self.has_advanced
        return out


def _get(mdata: Dict[str, Any], key: str, default: float) -> float:
    v = mdata.get(key)
    return default if v is None else float(v)


def _color(mdata: Dict[str, Any], default=(1.0, 1.0, 1.0)):
    c = mdata.get("color")
    if c is None:
        return list(default)
    return [float(c[0]), float(c[1]), float(c[2])]


def material_row(mdata: Dict[str, Any],
                 extended: bool = True) -> Dict[str, Any]:
    """One table row from a scene-JSON material dict.

    Unknown types fall back to lambertian, as in the reference loader.
    With ``extended=False`` (go-parity loading) the extended kinds do too,
    and textures are ignored.
    """
    mtype = str(mdata.get("type", "lambertian")).lower()
    names = EXTENDED_KIND_NAMES if extended else KIND_NAMES
    kind = names.get(mtype, LAMBERTIAN)

    albedo = _color(mdata)
    rough = min(_get(mdata, "roughness", 0.0), 1.0)
    emit = [0.0, 0.0, 0.0]
    ior = 1.5
    aux_vec = [0.0, 0.0, 0.0]
    aux_a = 0.0
    aux_b = 0.0
    if kind == LAMBERTIAN:
        rough, metallic, specular = 1.0, 0.0, 0.0
        eff_albedo = albedo
    elif kind == METAL:
        metallic = min(_get(mdata, "metallic", 1.0), 1.0)
        specular = min(_get(mdata, "specular", 1.0), 1.0)
        eff_albedo = albedo
    elif kind == SHINY:
        metallic = min(_get(mdata, "metallic", 0.0), 1.0)
        specular = min(_get(mdata, "specular", 1.0), 1.0)
        eff_albedo = albedo
    elif kind == PERFECT_MIRROR:
        metallic, specular = 1.0, 1.0
        ior = 2.0
        eff_albedo = albedo
    elif kind == GLASS:
        metallic, specular = 0.0, 1.0
        rough = 0.0
        ior = _get(mdata, "refractionIndex", 1.5)
        eff_albedo = albedo
    elif kind == DIELECTRIC:
        metallic, specular = 0.0, 1.0
        rough = 0.0
        ior = _get(mdata, "refractionIndex", 1.5)
        eff_albedo = [1.0, 1.0, 1.0]
        albedo = [1.0, 1.0, 1.0]
    elif kind == DIFFUSE_LIGHT:
        metallic, specular = 0.0, 0.0
        rough = 1.0
        emit = albedo
        eff_albedo = [0.0, 0.0, 0.0]
    elif kind == SUBSURFACE:
        metallic, specular = 0.0, 0.0
        eff_albedo = albedo
        aux_vec = list(mdata.get("absorption", (1.0, 1.0, 1.0)))
        aux_a = _get(mdata, "scatteringRadius", 1.0)
        aux_b = _get(mdata, "phaseFunction", 1.0)
    elif kind == ANISOTROPIC:
        metallic, specular = 0.0, 0.0
        eff_albedo = albedo
        aux_vec = list(mdata.get("direction", (1.0, 0.0, 0.0)))
        aux_a = _get(mdata, "anisotropy", 0.0)
    elif kind == CLEARCOAT:  # over a lambertian base
        metallic, specular = 0.0, 0.0
        eff_albedo = albedo
        ior = _get(mdata, "clearcoatIOR", 1.5)
        aux_a = _get(mdata, "strength", 0.5)
        aux_b = _get(mdata, "clearcoatRoughness", 0.1)
    elif kind == SHEEN:
        metallic, specular = 0.0, 0.0
        eff_albedo = albedo
        aux_vec = list(mdata.get("sheenColor", (1.0, 1.0, 1.0)))
        aux_a = _get(mdata, "sheenRoughness", 0.3)
        aux_b = _get(mdata, "sheenTint", 0.5)
    elif kind == MIRROR:
        metallic, specular = 1.0, 1.0
        eff_albedo = albedo
    else:  # EMISSION
        metallic, specular = 0.0, 0.0
        intensity = _get(mdata, "intensity", 1.0)
        emit = [c * intensity for c in albedo]
        eff_albedo = [0.0, 0.0, 0.0]
        mode = str(mdata.get("emissionType", "point")).lower()
        aux_a = {"point": EMISSION_POINT,
                 "directional": EMISSION_DIRECTIONAL,
                 "area": EMISSION_AREA}.get(mode, EMISSION_POINT)
        aux_b = _get(mdata, "falloff", 0.0)
    row = dict(kind=kind, albedo=albedo, roughness=rough,
               metallic=metallic, specular=specular, ior=ior, emit=emit,
               eff_albedo=eff_albedo, aux_vec=aux_vec, aux_a=aux_a,
               aux_b=aux_b)
    tex = mdata.get("texture") if extended else None
    if tex:
        row["texture"] = tex_mod.texture_from_dict(tex)
    return row


def row_key(row: Dict[str, Any]) -> tuple:
    """Hashable identity of a row, for load-time deduplication."""
    return (row["kind"], tuple(row["albedo"]), row["roughness"],
            row["metallic"], row["specular"], row["ior"],
            tuple(row["emit"]), tuple(row["eff_albedo"]),
            tuple(row["aux_vec"]), row["aux_a"], row["aux_b"],
            row.get("texture"))


def build_table(rows, device="cpu") -> MaterialTable:
    """Stack rows into a MaterialTable (at least one row).

    Values go float64 -> float32 through numpy, the cast of the JAX
    package's ``build_table``."""
    if not rows:
        rows = [material_row({"type": "lambertian", "color": [0, 0, 0]})]

    def f(k):
        return torch.from_numpy(
            np.array([r[k] for r in rows]).astype(np.float32)).to(device)

    kinds = np.array([r["kind"] for r in rows], np.int32)
    return MaterialTable(
        kind=torch.from_numpy(kinds).to(device),
        albedo=f("albedo"), roughness=f("roughness"),
        metallic=f("metallic"), specular=f("specular"), ior=f("ior"),
        emit=f("emit"), eff_albedo=f("eff_albedo"), aux_vec=f("aux_vec"),
        aux_a=f("aux_a"), aux_b=f("aux_b"),
        has_advanced=bool((kinds > DIFFUSE_LIGHT).any()),
        textures=tuple((i, r["texture"]) for i, r in enumerate(rows)
                       if r.get("texture") is not None))


# ---------------------------------------------------------------------------
# Vectorised scatter
# ---------------------------------------------------------------------------

def _dot(a, b):
    """Sum of products over the last axis in the order x, y, z."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])[..., None]


def _pow5(x):
    """x**5 keeping the sign of negative bases (unnormalised rays)."""
    x2 = x * x
    return x2 * x2 * x


def _normalize(v):
    """Go's Normalize: the zero vector stays zero."""
    n = _sqrt(_dot(v, v))
    pos = n > 0.0
    return torch.where(pos, v / torch.where(pos, n, torch.ones_like(n)),
                       torch.zeros_like(v))


def _reflect(d, n):
    return d - 2.0 * _dot(d, n) * n


def _refract(v, n, eta):
    """Go Vec3.Refract including its total-internal-reflection branch."""
    cos = _dot(v, n)
    flip = cos > 0.0
    n2 = torch.where(flip, -n, n)
    eta2 = torch.where(flip, 1.0 / eta, eta)
    cos2 = torch.where(flip, -cos, cos)
    sin_t2 = eta2 * eta2 * (1.0 - cos2 * cos2)
    tir = sin_t2 > 1.0
    cos_t2 = _sqrt(torch.where(tir, torch.ones_like(sin_t2),
                               torch.clamp(1.0 - sin_t2, min=0.0)))
    refracted = v * eta2 - n2 * (eta2 * cos2 + cos_t2)
    return torch.where(tir, _reflect(v, n2), refracted)


def _schlick(cos, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * _pow5(1.0 - cos)


def scatter(mat, ray_dir, normal, front_face, ball, pick_u):
    """Material.Scatter for a batch of lanes.

    mat: per-lane parameters from ``MaterialTable.row``; ray_dir (B,3),
    not normalised (Go parity); normal (B,3) front-face flipped;
    front_face (B,) bool; ball (B,3) unit-ball sample; pick_u (B,) uniform.
    Returns (scatter_dir (B,3), attenuation (B,3), did_scatter (B,) bool).
    DiffuseLight and Emission never scatter; a Mirror scatters only while
    its (unnormalised) perturbed reflection stays above the surface.
    """
    kind = mat["kind"]
    rough = mat["roughness"][..., None]
    metallic = mat["metallic"][..., None]
    spec = mat["specular"][..., None]
    ior = mat["ior"][..., None]
    albedo = mat["albedo"]

    reflected = _reflect(ray_dir, normal)
    cos_raw = torch.abs(_dot(ray_dir, normal))
    f0 = (ior - 1.0) / (ior + 1.0)
    f0 = f0 * f0
    fresnel = f0 + (1.0 - f0) * _pow5(1.0 - cos_raw)

    lam_dir = normal + ball
    near_zero = torch.all(torch.abs(lam_dir) < 1e-8, dim=-1, keepdim=True)
    lam_dir = _normalize(torch.where(near_zero, normal, lam_dir))

    perturbed = _normalize(reflected + ball * rough)
    metal_dir = torch.where(rough > 0.001, perturbed, reflected)
    fs = 0.6 + metallic * 0.4
    metal_att = torch.clamp(albedo * (1.0 - fs) + fresnel * fs, 0.0, 1.0)
    mfs = 0.4 + metallic * 0.5
    metal_att = torch.where(metallic > 0.8,
                            metal_att * (1.0 - mfs) + fresnel * mfs,
                            metal_att)

    shiny_dir = torch.where(rough > 0.0, perturbed, reflected)
    ss = 0.4 + spec * 0.4
    shiny_att = torch.clamp(albedo * (1.0 - ss) + fresnel * ss, max=1.0)

    pm_att = albedo * 0.1 + fresnel * 0.9

    unit_dir = _normalize(ray_dir)
    ratio = torch.where(front_face[..., None], 1.0 / ior, ior)
    cos_t = torch.clamp(_dot(-unit_dir, normal), max=1.0)
    sin_t = _sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ratio * sin_t > 1.0
    use_reflect = cannot | (_schlick(cos_t, ratio) > pick_u[..., None])
    glass_dir = torch.where(use_reflect, _reflect(unit_dir, normal),
                            _refract(unit_dir, normal, ratio))

    k = kind[..., None]
    out_dir = torch.where(
        k == LAMBERTIAN, lam_dir, torch.where(
            k == METAL, metal_dir, torch.where(
                k == SHINY, shiny_dir, torch.where(
                    k == PERFECT_MIRROR, metal_dir, glass_dir))))
    out_att = torch.where(
        k == LAMBERTIAN, albedo, torch.where(
            k == METAL, metal_att, torch.where(
                k == SHINY, shiny_att, torch.where(
                    k == PERFECT_MIRROR, pm_att, albedo))))
    did_scatter = kind != DIFFUSE_LIGHT
    if not mat.get("has_advanced"):
        return out_dir, out_att, did_scatter

    av = mat["aux_vec"]
    aa = mat["aux_a"][..., None]
    ab = mat["aux_b"][..., None]
    sss_dir = ball * ab
    sss_att = albedo * (av * aa)
    arough = rough * (1.0 + aa * _dot(av, normal))
    ani_dir = torch.where(arough > 0.0,
                          _normalize(reflected + ball * arough), reflected)
    cc_att = albedo * (1.0 - aa) + fresnel * aa
    sheen_col = av * (1.0 - ab) + albedo * ab
    sheen_dir = torch.where(aa > 0.0, _normalize(reflected + ball * aa),
                            reflected)
    mir_dir = torch.where(rough > 0.0, reflected + ball * rough, reflected)
    mir_up = _dot(mir_dir, normal)[..., 0] > 0.0
    out_dir = torch.where(
        k == SUBSURFACE, sss_dir, torch.where(
            k == ANISOTROPIC, ani_dir, torch.where(
                k == CLEARCOAT, lam_dir, torch.where(
                    k == SHEEN, sheen_dir, torch.where(
                        k == MIRROR, mir_dir, out_dir)))))
    out_att = torch.where(
        k == SUBSURFACE, sss_att, torch.where(
            k == ANISOTROPIC, albedo, torch.where(
                k == CLEARCOAT, cc_att, torch.where(
                    k == SHEEN, sheen_col, torch.where(
                        k == MIRROR, albedo, out_att)))))
    did_scatter = (did_scatter & (kind != EMISSION)
                   & ((kind != MIRROR) | mir_up))
    return out_dir, out_att, did_scatter
