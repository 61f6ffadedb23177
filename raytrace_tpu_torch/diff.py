"""Differentiable rendering and inverse rendering (port of
``raytrace_tpu/diff.py``).

Reverse mode runs PyTorch autograd through the eager engine
(``trace.trace`` with ``loop="scan"``: the compacted bounce loop, each
bounce under ``torch.utils.checkpoint``, so the backward pass keeps the
rays between bounces and runs each bounce's intersections again instead
of keeping them). Every Monte Carlo draw is a function of (pixel, sample,
bounce) counters, independent of the scene's parameters, so the pathwise
derivative is unbiased for smooth parameters (albedo, intensity,
roughness away from its tier thresholds); hit/miss boundaries and branch
picks get the biased but useful pathwise gradient; geometry
differentiates through the closed-form hit distance of the winning
primitive. With a scene BVH (``split_params(keep_accel=True)``) the tree
walk runs without autograd and the winner's t is re-derived
straight-through (``ops/intersect._winner_t_diff``).

No fused kernel runs here: the JAX path reaches no Pallas kernel either.
Everything runs on the scene's device, or with ``make_train_step(mesh=)``
on the devices of the mesh's coordinates.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from . import renderer as renderer_mod
from . import trace as trace_mod
from ._f32 import sqrt_grad_safe as _sqrt
from .ops.intersect import _dot

# Differentiable fields of the Scene, by (group, field).
DIFF_FIELDS = {
    "geometry": ("sph_center", "sph_radius", "tri_v0", "tri_v1", "tri_v2",
                 "pl_point", "pl_normal"),
    "materials": ("albedo", "roughness", "metallic", "specular", "ior",
                  "emit", "eff_albedo"),
    "lights": ("position", "color", "intensity"),
    "camera": ("position",),
}


def _unit(v):
    """v / |v| where |v| > 0, else v unchanged (diff.py's double-where)."""
    n = _sqrt(_dot(v, v))[..., None]
    pos = n > 0.0
    return torch.where(pos, v / torch.where(pos, n, torch.ones_like(n)), v)


def split_params(scene, keep_accel: bool = False):
    """Scene -> (params, merge): the dict of the scene's differentiable
    tensors ({group: {field: tensor}}, the scene's own tensors) and the
    function that rebuilds a Scene from such a dict.

    ``merge`` recomputes the unit triangle normals from the vertices (so
    vertex gradients reach the shading normal), normalises the plane
    normals, and drops the box occluders (optimised vertices break a
    cube's closed-box premise: the faces are tested as triangles). It
    drops the scene's BVH unless ``keep_accel``: the tree was built for
    the original geometry, and moving primitives under a stale tree can
    cull them. Keep it only when every geometry field stays frozen."""
    params: Dict[str, Dict[str, Any]] = {
        group: {f: getattr(getattr(scene, group), f) for f in fields}
        for group, fields in DIFF_FIELDS.items()}

    def merge(p):
        geom = dataclasses.replace(scene.geometry, **p["geometry"])
        n = torch.linalg.cross(geom.tri_v1 - geom.tri_v0,
                               geom.tri_v2 - geom.tri_v0, dim=-1)
        dev = geom.tri_v0.device
        geom = dataclasses.replace(
            geom, tri_normal=_unit(n), pl_normal=_unit(geom.pl_normal),
            box_min=torch.zeros((0, 3), dtype=torch.float32, device=dev),
            box_max=torch.zeros((0, 3), dtype=torch.float32, device=dev),
            box_mat=torch.zeros((0,), dtype=torch.int32, device=dev),
            occl_tris=-1)
        return dataclasses.replace(
            scene, geometry=geom,
            materials=dataclasses.replace(scene.materials, **p["materials"]),
            lights=dataclasses.replace(scene.lights, **p["lights"]),
            camera=dataclasses.replace(scene.camera, **p["camera"]),
            accel=scene.accel if keep_accel else None)

    return params, merge


def _diff_cfg(cfg: trace_mod.TraceConfig) -> trace_mod.TraceConfig:
    return dataclasses.replace(cfg, loop="scan")


def _leaves(params):
    """Fresh leaf tensors (requires_grad) with the values of ``params``."""
    return {g: {f: t.detach().clone().requires_grad_(True)
                for f, t in sub.items()} for g, sub in params.items()}


def _flat(params):
    return [t for sub in params.values() for t in sub.values()]


def _grads(params, grads):
    """{group: {field: gradient}} from autograd's list in ``_flat``'s
    order, zeros where it reached nothing."""
    flat = iter(grads)
    out = {}
    for g, sub in params.items():
        out[g] = {}
        for f, t in sub.items():
            gr = next(flat)
            out[g][f] = torch.zeros_like(t) if gr is None else gr
    return out


def render_image(scene, width: int, height: int, samples: int,
                 cfg: trace_mod.TraceConfig, go_camera: bool = True):
    """Differentiable whole-image render: (H, W, 3) linear radiance, the
    mean of ``samples`` lanes a pixel, traced as one flat wavefront by the
    scan loop (the lanes of ``renderer.render_band`` over the whole
    frame)."""
    n_px = width * height
    pix, samp = renderer_mod._lane_ids(
        torch.arange(n_px, device=scene.device), samples)
    rad = renderer_mod.lane_radiance(scene, pix, samp, width=width,
                                     height=height, cfg=_diff_cfg(cfg),
                                     go_camera=go_camera)
    return rad.reshape(n_px, samples, 3).mean(dim=1).reshape(
        height, width, 3)


def render_and_grad(scene, width: int, height: int, *, samples: int,
                    cfg: trace_mod.TraceConfig, go_camera: bool = True,
                    keep_accel: bool = False):
    """(image, d(sum of pixels)/d(params)): the image (H, W, 3) and the
    gradient of its sum with respect to every field of ``split_params``,
    as a dict of tensors of the fields' shapes. ``keep_accel`` is
    ``split_params``' (the port's keyword: the JAX function always drops
    the accel)."""
    params, merge = split_params(scene, keep_accel=keep_accel)
    leaves = _leaves(params)
    img = render_image(merge(leaves), width, height, samples, cfg, go_camera)
    grads = torch.autograd.grad(img.sum(), _flat(leaves), allow_unused=True)
    return img.detach(), _grads(leaves, grads)


class TrainState(NamedTuple):
    params: Any      # {group: {field: leaf tensor}}, updated in place
    opt_state: Any   # the torch.optim.Optimizer over those leaves
    step: int


def make_train_step(scene, target, *, width: int, height: int,
                    samples: int, cfg: trace_mod.TraceConfig,
                    optimizer=None, go_camera: bool = True, mesh=None,
                    trainable=None):
    """Build (init_state, step_fn) for inverse rendering.

    ``step_fn(state) -> (state, loss)``: the MSE between the rendered
    image and ``target`` (H, W, 3), its gradients with respect to every
    differentiable field, and one optimizer step. ``state.params`` holds
    fresh leaf tensors (the scene's own are not touched), which the
    optimizer updates in place; to resume, copy saved values into them
    (``convert.params_from_numpy`` carries the JAX package's).

    ``optimizer``: a function from the list of leaf tensors to a
    ``torch.optim.Optimizer`` (e.g. ``functools.partial(torch.optim.Adam,
    lr=5e-2)``); by default ``torch.optim.Adam`` at lr 1e-2, whose update
    is optax's ``adam``: -lr * m_hat / (sqrt(v_hat) + eps), eps = 1e-8
    added outside the square root (optax's eps_root = 0).

    ``trainable``: optional "group.field" names (e.g.
    {"lights.intensity"}); the gradients of every other field are zeroed
    before the step (with an adaptive optimizer, unconstrained near-zero
    gradients on geometry would otherwise random-walk the scene).

    ``mesh`` (``parallel.make_mesh``): the lanes shard over (px, sp), as in
    the JAX package (``_sharded_loss``); pixels and samples must divide
    the mesh. One set of parameters takes the step: within a process every
    coordinate reads it through a differentiable copy to its device; under
    a process group every process holds the same parameters, and the
    gradients are summed over the processes before the step, so they stay
    the same.
    """
    params0, merge = split_params(scene)
    params = _leaves(params0)
    make_opt = optimizer or functools.partial(torch.optim.Adam, lr=1e-2)
    opt = make_opt(_flat(params))
    keep = None if trainable is None else set(trainable)
    n_px = width * height
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=scene.device).reshape(n_px, 3)
    if mesh is None:
        def loss_fn(p):
            img = render_image(merge(p), width, height, samples, cfg,
                               go_camera)
            return torch.mean((img.reshape(n_px, 3) - target) ** 2)
    else:
        n_shards, n_sp = mesh.shape["px"], mesh.shape["sp"]
        if n_px % n_shards or samples % n_sp:
            raise ValueError(
                f"pixels ({n_px}) and samples ({samples}) must divide the "
                f"mesh ({n_shards}x{n_sp}) for the sharded train step")
        loss_fn = functools.partial(
            _sharded_loss, scene=scene, target=target, width=width,
            height=height, samples=samples, cfg=cfg, go_camera=go_camera,
            mesh=mesh)

    def step(state: TrainState):
        loss = loss_fn(state.params)
        # under a process group: see _sharded_loss
        world = (torch.distributed.get_world_size()
                 if mesh is not None and mesh.multi_process else 1)
        grads = _grads(state.params, torch.autograd.grad(
            loss / world, _flat(state.params), allow_unused=True))
        if world > 1:
            for g in _flat(grads):
                torch.distributed.all_reduce(g)
        for g, sub in state.params.items():
            for f, t in sub.items():
                gr = grads[g][f]
                t.grad = (gr if keep is None or f"{g}.{f}" in keep
                          else torch.zeros_like(gr))
        state.opt_state.step()
        return (TrainState(state.params, state.opt_state, state.step + 1),
                loss.detach())

    return TrainState(params, opt, 0), step


def _sharded_loss(params, *, scene, target, width: int, height: int,
                  samples: int, cfg: trace_mod.TraceConfig, go_camera: bool,
                  mesh) -> torch.Tensor:
    """The train step's loss with the lanes sharded over (px, sp)
    (raytrace_tpu/diff.py:212-258): coordinate (i, j) traces the samples
    of sp shard j for the pixels of px shard i on its device, from the
    parameters copied there (a differentiable copy); the px shard adds its
    sp partial sums in order on its device before the square; the shards'
    sums fill a zero (n_px, 3) image on the mesh's home device, and the
    loss is its squared error summed over n_px * 3.

    Under a process group each process fills its own coordinates' rows and
    ``torch.distributed.nn.functional.all_reduce`` sums the images over
    the processes, differentiably; every process then holds the whole
    image and the same loss. The step takes the gradient of loss / world:
    the all_reduce's backward sums the processes' gradients of the image,
    so each process's parameters receive its own lanes' part of the
    gradient, and the step sums those over the processes."""
    n_px = width * height
    n_shards, n_sp = mesh.shape["px"], mesh.shape["sp"]
    np_l, ns_l = n_px // n_shards, samples // n_sp
    dcfg = _diff_cfg(cfg)
    merged = {}
    home = mesh.home
    img = torch.zeros((n_px, 3), dtype=torch.float32, device=home)
    for i in range(n_shards):
        total = None
        for j in range(n_sp):
            if not mesh.is_local(i, j):
                continue
            dev = mesh.devices[i, j]
            if dev not in merged:
                _, merge_d = split_params(scene.to(dev))
                merged[dev] = merge_d({g: {f: t.to(dev) for f, t in
                                           sub.items()}
                                       for g, sub in params.items()})
            pix, samp = renderer_mod._lane_ids(
                torch.arange(i * np_l, (i + 1) * np_l, device=dev), ns_l,
                offset=j * ns_l)
            rad = renderer_mod.lane_radiance(merged[dev], pix, samp,
                                             width=width, height=height,
                                             cfg=dcfg, go_camera=go_camera)
            part = rad.reshape(np_l, ns_l, 3).sum(dim=1)
            total = part if total is None else total + part.to(total.device)
        if total is not None:  # the shards' rows are disjoint: exact
            img = img.index_add(0, torch.arange(i * np_l, (i + 1) * np_l,
                                                device=home), total.to(home))
    if mesh.multi_process:
        from torch.distributed.nn import functional as dist_fn
        img = dist_fn.all_reduce(img)
    err = img / samples - target.reshape(n_px, 3).to(home)
    return torch.sum(err * err) / (n_px * 3)


def finite_difference_grad(scene, width: int, height: int, *, samples: int,
                           cfg: trace_mod.TraceConfig, group: str,
                           field: str, index, eps: float = 1e-3,
                           go_camera: bool = True,
                           keep_accel: bool = False) -> float:
    """Central-difference d(sum of pixels)/d(param[index]), for checking
    the gradients: the parameter moved by +-eps in float64 and rounded to
    float32, each image summed in float64. ``keep_accel`` as in
    ``render_and_grad``."""
    params, merge = split_params(scene, keep_accel=keep_accel)
    base = params[group][field]
    total = []
    for sgn in (1.0, -1.0):
        arr = base.detach().cpu().numpy().astype(np.float64)
        arr[index] += sgn * eps
        p = {g: dict(sub) for g, sub in params.items()}
        p[group][field] = torch.from_numpy(arr.astype(np.float32)).to(
            base.device)
        with torch.no_grad():
            img = render_image(merge(p), width, height, samples, cfg,
                               go_camera)
        total.append(float(img.to(torch.float64).sum()))
    return (total[0] - total[1]) / (2 * eps)
