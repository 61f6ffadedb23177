"""The bounce loop in plain PyTorch: the eager engine, and the plain version
of K1 and of K3+K4.

Port of ``raytrace_tpu/trace.py``; with a scene BVH (``scene.accel``) every
closest-hit and shadow test walks the tree. The reference's recursion
(depth <= 50) becomes a loop over a struct-of-arrays wavefront that
accumulates

    radiance += throughput * (emitted + direct * w_d)
    throughput *= attenuation * w_r

with (w_r, w_d) the metallic-tier weights. Lanes die on a miss, on a
material that does not scatter (DiffuseLight, Emission, a Mirror whose
reflection dips below the surface: each adds emitted + direct unweighted)
or at max depth. A directional Emission scales its light by max(n.y, 0);
a textured material takes the texture's albedo at the hit point, for
scatter and direct light alike. Each bounce works only on the lanes still alive: a dead
lane's state never changes, so dropping it gives the same per-lane result
as the JAX package's masked loop and keeps the eager engine cheap.

Two options of the JAX engine ride on the same loop. Thin-lens depth of
field (``dof_lens_radius``, ``dof_focus_distance``) perturbs the camera
rays before the trace (``camera.thin_lens_perturb``, applied by the
renderer's ray generation). ``fast_mc`` - a throughput cutoff and Russian
roulette from ``russian_roulette_start`` on - ends dim lanes early and
boosts the survivors by 1/q (``fast_mc``). The boost multiplies by the
reciprocal, as the JAX kernel does and as the trace kernels do, so the
plain version and the kernels agree bit for bit; the JAX engine divides,
which can round one ulp apart and move a later roulette verdict.

``TraceConfig.loop`` picks the form of the same loop, as in the JAX
package: ``"while"`` (the default; the plain version of the trace
kernels) or ``"scan"``, the reverse-differentiable form for ``diff.py``.
"scan" runs each bounce of the one loop under a non-reentrant
``torch.utils.checkpoint`` (the backward pass runs the bounce again
instead of keeping its intersection tensors: every draw is a function of
pixel, sample and bounce, so the rerun is exact); the loop itself is the
same, so its forward pass equals "while" bit for bit. Autograd follows
the loop's indexed writes to the radiance, and the non-reentrant form
keeps the gradients of the scene's tensors, which the bounce reads
through ``scene`` rather than as arguments (the reentrant one would drop
them). ``BOUNCES["run"]`` counts the bounces run, forward or rerun.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from . import rng
from .models import materials as mat_mod
from .models import textures as tex_mod
from .ops import intersect, shade


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Trace settings (the reference's settings.go)."""

    max_depth: int = 50
    soft_shadows: bool = True
    shadow_samples: int = 16
    recursive_reflections: bool = True
    seed: int = 0
    # thin-lens depth of field, applied to the camera rays
    # (camera.thin_lens_perturb; the Go defaults, advanced.go:34-35)
    depth_of_field: bool = False
    dof_lens_radius: float = 0.1
    dof_focus_distance: float = 10.0
    # fast_mc: Russian roulette from this bounce on (None: off) and the
    # throughput below which a lane dies (0: off)
    russian_roulette_start: Optional[int] = None
    throughput_epsilon: float = 0.0
    # the loop's form: "while" (in place) or "scan" (per-bounce
    # checkpoints, reverse-differentiable)
    loop: str = "while"


def fast_mc(cfg: TraceConfig, bounce: int, pix, samp, tp):
    """The fast_mc step after a bounce's throughput update, for lanes that
    scattered: (survivors (B,) bool, or None when neither part is on at
    this bounce; throughput with the survivors' roulette boost).

    A lane whose brightest channel is below ``throughput_epsilon`` dies;
    from ``russian_roulette_start`` on, a lane survives with probability
    q = clip(max(tp), 0.05, 1) (one draw of the RUSSIAN_ROULETTE site) and
    a survivor's throughput is multiplied by 1/q."""
    rr = (cfg.russian_roulette_start is not None
          and bounce >= cfg.russian_roulette_start)
    if cfg.throughput_epsilon <= 0.0 and not rr:
        return None, tp
    tmax = torch.amax(tp, dim=-1)
    go = torch.ones_like(tmax, dtype=torch.bool)
    if cfg.throughput_epsilon > 0.0:
        go = tmax >= float(np.float32(cfg.throughput_epsilon))
    if rr:
        q = torch.clamp(tmax, min=0.05, max=1.0)
        u = rng.uniform4(pix, samp,
                         rng.bounce_stream(bounce,
                                           rng.Streams.RUSSIAN_ROULETTE),
                         cfg.seed)[0]
        go = go & ~(u >= q)
        inv_q = torch.ones_like(q) / q
        tp = torch.where(go[:, None], tp * inv_q[:, None], tp)
    return go, tp


BOUNCES = {"run": 0}


def _bounce(scene, pix, samp, cfg, bounce, origin, direction, throughput):
    """One shading iteration over live lanes.

    Returns (indices of the lanes that hit, their emitted and direct
    radiance terms, scattering mask among them, next origin, next
    direction, next throughput)."""
    BOUNCES["run"] += 1
    geom, mats, lights = scene.geometry, scene.materials, scene.lights
    # the scene BVH, when there is one: the same hits, walked
    accel = scene.accel
    hit = intersect.closest_hit(geom, origin, direction, t_min=1e-3,
                                accel=accel)
    keep = hit.hit.nonzero()[:, 0]
    pix, samp = pix[keep], samp[keep]
    d = direction[keep]
    tp = throughput[keep]
    point = hit.point[keep]
    normal = hit.normal[keep]
    mat_id = hit.mat_id[keep]
    mat = mats.row(mat_id)
    emit = mat["emit"]
    if mats.has_advanced:
        is_dir = ((mat["kind"] == mat_mod.EMISSION)
                  & (mat["aux_a"] == mat_mod.EMISSION_DIRECTIONAL))
        emit = torch.where(is_dir[..., None],
                           emit * torch.clamp(normal[..., 1:2], min=0.0),
                           emit)
    if mats.textures:
        alb, eff = mat["albedo"], mat["eff_albedo"]
        for mi, tex in mats.textures:
            sel = (mat_id == mi)[..., None]
            t_alb = tex_mod.textured_albedo(tex, point, alb)
            alb = torch.where(sel, t_alb, alb)
            eff = torch.where(sel, t_alb, eff)
        mat = {**mat, "albedo": alb, "eff_albedo": eff}

    direct = shade.direct_lighting(
        geom, lights, mat, point, normal, pix, samp, bounce,
        soft_shadows=cfg.soft_shadows, shadow_samples=cfg.shadow_samples,
        seed=cfg.seed, accel=accel)
    ball = rng.unit_ball(pix, samp,
                         rng.bounce_stream(bounce, rng.Streams.SCATTER_BALL),
                         cfg.seed)
    pick = rng.uniform4(pix, samp,
                        rng.bounce_stream(bounce, rng.Streams.DIELECTRIC),
                        cfg.seed)[0]
    scat_dir, atten, did_scatter = mat_mod.scatter(
        mat, d, normal, hit.front_face[keep], ball, pick)
    w_r, w_d = shade.combine_weights(mat["metallic"])

    emitted = tp * emit
    # A lane that does not scatter ends with emitted + direct unweighted.
    lit = torch.where(did_scatter[..., None], tp * direct * w_d[..., None],
                      tp * direct)
    new_tp = tp * atten * w_r[..., None]
    return keep, emitted, lit, did_scatter, point, scat_dir, new_tp


def state_dict(state: torch.Tensor) -> dict:
    """The resumable lane state, (B,10) float32 [origin.xyz, direction.xyz,
    throughput.xyz, alive], as the JAX package's dict of views."""
    return {"origin": state[:, 0:3], "direction": state[:, 3:6],
            "throughput": state[:, 6:9], "alive": state[:, 9]}


def trace(scene, origin, direction, pix_id, samp_id, cfg: TraceConfig, *,
          start_bounce: int = 0, end_bounce: Optional[int] = None,
          init_throughput=None, init_alive=None, return_state: bool = False):
    """Trace a wavefront of rays: radiance (B,3), or (radiance, state).

    origin/direction: (B,3) float32 camera rays (direction unnormalised);
    pix_id/samp_id: (B,) integer lane identities keying the RNG.

    The resumable form (K1-state's plain version; the contract of the JAX
    package's ``trace_pallas``, :2987-3001) runs bounces
    [start_bounce, min(end_bounce, max_depth)) from ``init_throughput``
    (default ones) for the lanes whose ``init_alive`` is nonzero (default
    every lane); the radiance is that segment's alone, 0 for a lane that
    starts dead. With ``return_state`` it also returns the state each lane
    carries into bounce ``end_bounce`` (``state_dict``): a lane still alive
    has the origin, direction and throughput of its next ray; a lane that
    died keeps those of the bounce where it missed or stopped scattering.
    Draws key off the absolute bounce index, so [0,b) and then [b,D) from
    the state sum to the [0,D) radiance up to one float add.

    With ``cfg.loop == "scan"`` each bounce runs under a checkpoint, and
    the resumable form is not available.
    """
    if cfg.loop == "while":
        step = _bounce
    elif cfg.loop == "scan":
        if (start_bounce or end_bounce is not None or return_state
                or init_throughput is not None or init_alive is not None):
            raise ValueError("the resumable trace runs only with "
                             "loop='while'")
        step = functools.partial(torch.utils.checkpoint.checkpoint, _bounce,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
    else:
        raise ValueError(f"unknown loop {cfg.loop!r}: 'while' or 'scan'")
    n = origin.shape[0]
    radiance = torch.zeros_like(direction)
    tp_all = (torch.ones_like(direction) if init_throughput is None
              else init_throughput.to(torch.float32))
    if init_alive is None:
        lanes = torch.arange(n, device=origin.device)
        alive_all = torch.ones(n, dtype=torch.float32, device=origin.device)
    else:
        alive_all = (init_alive > 0).to(torch.float32)
        lanes = alive_all.nonzero()[:, 0]
    state = None
    if return_state:
        state = torch.cat([origin, direction, tp_all, alive_all[:, None]],
                          1).to(torch.float32)
    o, d, tp = origin[lanes], direction[lanes], tp_all[lanes]
    pix, samp = pix_id[lanes], samp_id[lanes]
    end = cfg.max_depth if end_bounce is None else min(end_bounce,
                                                       cfg.max_depth)
    for bounce in range(start_bounce, end):
        if lanes.numel() == 0:
            break
        keep, emitted, lit, scat, point, new_d, new_tp = step(
            scene, pix, samp, cfg, bounce, o, d, tp)
        if state is not None:
            state[lanes, 9] = 0.0  # alive again only if it scatters on
        lanes = lanes[keep]
        # two adds in the JAX package's order: (R + emitted) + direct
        radiance[lanes] = radiance[lanes] + emitted
        radiance[lanes] = radiance[lanes] + lit
        live = scat.nonzero()[:, 0]
        lanes = lanes[live]
        pix, samp = pix[keep][live], samp[keep][live]
        o, d, tp = point[live], new_d[live], new_tp[live]
        if state is not None:
            state[lanes, 0:3] = o
            state[lanes, 3:6] = d
            state[lanes, 6:9] = tp
        if not cfg.recursive_reflections:
            break
        go, tp = fast_mc(cfg, bounce, pix, samp, tp)
        if go is not None:
            keep_go = go.nonzero()[:, 0]
            lanes, pix, samp = lanes[keep_go], pix[keep_go], samp[keep_go]
            o, d, tp = o[keep_go], d[keep_go], tp[keep_go]
            if state is not None:
                state[lanes, 6:9] = tp
        if state is not None:
            state[lanes, 9] = 1.0
    if state is None:
        return radiance
    return radiance, state_dict(state)
