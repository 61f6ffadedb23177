"""The port's differentiable path (raytrace_tpu_torch/diff.py) on the CPU.

Held against the JAX package's diff module on the scenes and at the size
of tests/test_diff.py (12x8, 2 spp, depth 3, 2 shadow samples), the JAX
side jitted once a scene (module fixtures):

* split_params: the same groups, fields and shapes; the JAX dict carried
  across by convert.params_from_numpy equals the port's own bit for bit;
  merge drops the box occluders and the BVH;
* the image within atol 1e-5 of JAX's render_image, on the simple scene
  and on the cube scene (glass sphere before a cube: boxes disabled);
* every gradient leaf within rtol 1e-3, atol 1e-5 of JAX's AD (compiled
  XLA contracts multiply-adds, so the two round apart);
* the "scan" loop's forward pass equal to "while" bit for bit, and its
  gradient (a bounce run again in the backward pass, the scene's tensors
  reaching it through the closure) equal to the "while" loop's within
  rtol 1e-6;

and, within the port, the finite-difference gates of tests/test_diff.py
at their own tolerances (albedo, light intensity and position, sphere
radius, triangle vertices, IOR, camera position, depth 6), the 1,001-prim
gradient (10x8, 1 spp, depth 2) against a central difference, keep_accel
(the forward bit-equal to brute force, gradients within rtol 1e-3, atol
1e-6, and a light scale recovered through the walk: loss down more than
100x), inverse rendering (intensity within 10%), the default optimizer
against optax's adam over 5 steps of the same gradients (rtol 1e-5), an
exactly tangent ray (finite gradients), mesh= refused, and the two tools
at a small size.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import raytrace_tpu as rt
from raytrace_tpu import diff as jdiff
from raytrace_tpu import trace as jtrace
from raytrace_tpu_torch import convert
from raytrace_tpu_torch import diff as tdiff
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench import suite
from raytrace_tpu_torch.tools import inverse_rendering, measure_grad_scale
from test_torch_scene import one_torch_thread  # noqa: F401

W, H, SPP = 12, 8, 2
JCFG = jtrace.TraceConfig(max_depth=3, shadow_samples=2)
TCFG = ttrace.TraceConfig(max_depth=3, shadow_samples=2)

def ring_dict(metal: bool, intensity: float, light):
    """tests/test_diff.py's 121-prim accel scene: three rings of 40
    spheres over a plane."""
    objs = [{"type": "plane", "position": [0, -0.8, 0],
             "normal": [0, 1, 0],
             "material": {"type": "lambertian", "color": [0.5, 0.5, 0.5]}}]
    for i in range(120):
        a = 2 * math.pi * i / 120
        ring = i // 40
        objs.append({"type": "sphere",
                     "position": [(2.5 + ring) * math.cos(a), 0.3 * ring,
                                  (2.5 + ring) * math.sin(a) - 6],
                     "radius": 0.3,
                     "material": {"type": (["lambertian", "metal"][i % 2]
                                           if metal else "lambertian"),
                                  "color": [0.7, 0.4, 0.3],
                                  "roughness": 0.2}})
    return {"camera": {"position": [0, 2, 3], "aspectRatio": 1.33},
            "objects": objs,
            "lights": [{"type": "point", "position": light,
                        "color": [1, 1, 1], "intensity": intensity}]}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def scenes(simple_scene_dict):
    """{name: (JAX scene, port scene)} of the simple and the cube scene
    (the port's copies of tests/conftest.py's and tests/test_diff.py's
    dicts, pinned to them here)."""
    import test_diff
    assert suite.diff_scene_dict("simple") == simple_scene_dict
    assert suite.diff_scene_dict("cube") == test_diff.CUBE_SCENE
    return {name: (rt.scene_from_dict(suite.diff_scene_dict(name))[0],
                   tscene.from_dict(suite.diff_scene_dict(name),
                                    device="cpu")[0])
            for name in ("simple", "cube")}


@pytest.fixture(scope="module")
def both(scenes):
    """{name: ((JAX image, JAX grads), (port image, port grads))}, numpy."""
    out = {}
    for name, (js, ts) in scenes.items():
        jimg, jg = jdiff.render_and_grad(js, W, H, samples=SPP, cfg=JCFG)
        timg, tg = tdiff.render_and_grad(ts, W, H, samples=SPP, cfg=TCFG)
        out[name] = ((np.asarray(jimg), np_tree(jg)),
                     (timg.numpy(), {g: {f: v.numpy() for f, v in s.items()}
                                     for g, s in tg.items()}))
    return out


@pytest.mark.parametrize("name", ["simple", "cube"])
def test_split_params_matches_jax(scenes, name):
    js, ts = scenes[name]
    jp, jmerge = jdiff.split_params(js)
    tp, tmerge = tdiff.split_params(ts)
    assert tdiff.DIFF_FIELDS == {g: tuple(f) for g, f in
                                 jdiff.DIFF_FIELDS.items()}
    carried = convert.params_from_numpy(np_tree(jp), device="cpu")
    for g, fields in tdiff.DIFF_FIELDS.items():
        for f in fields:
            assert tuple(tp[g][f].shape) == np.asarray(jp[g][f]).shape
            assert carried[g][f].dtype == torch.float32
            assert torch.equal(carried[g][f], tp[g][f]), (g, f)
    jm, tm = jmerge(jp), tmerge(tp)
    assert tm.geometry.box_min.shape[0] == 0 == jm.geometry.box_min.shape[0]
    assert tm.geometry.occl_tris == -1
    assert tm.accel is None
    # merge's triangle normals are the face normals (one ulp at most)
    np.testing.assert_allclose(tm.geometry.tri_normal.numpy(),
                               np.asarray(jm.geometry.tri_normal),
                               rtol=0, atol=1e-6)
    if name == "cube":  # the forward scene has its box, merge drops it
        assert ts.geometry.box_min.shape[0] == 1


@pytest.mark.parametrize("name", ["simple", "cube"])
def test_image_matches_jax(both, name):
    (jimg, _), (timg, _) = both[name]
    assert timg.max() > 0.05
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["simple", "cube"])
def test_grads_match_jax(both, name):
    (_, jg), (_, tg) = both[name]
    for g, sub in tg.items():
        for f, v in sub.items():
            assert np.isfinite(v).all(), (g, f)
            np.testing.assert_allclose(v, jg[g][f], rtol=1e-3, atol=1e-5,
                                       err_msg=f"{g}.{f}")


@pytest.mark.parametrize("name", ["simple", "cube"])
def test_scan_equals_while(scenes, both, name):
    """The scan loop's image (the port's render_and_grad) equals the
    while loop's over the same lanes bit for bit."""
    ts = scenes[name][1]
    ref = trender.render_band(ts, 0, width=W, height=H, band_h=H,
                              samples=SPP, cfg=TCFG)
    assert torch.equal(torch.from_numpy(both[name][1][0]), ref)


def test_scan_gradient_reaches_closure_parameters(scenes):
    """Under "scan" every bounce runs in a non-reentrant checkpoint and
    reads the scene's tensors through its closure; they still receive
    their gradient, equal to the un-checkpointed "while" loop's (autograd
    through its in-place radiance), and the camera rays' too."""
    ts = scenes["cube"][1]
    params, merge = tdiff.split_params(ts)

    def grads(loop):
        leaves = tdiff._leaves(params)
        cfg = dataclasses.replace(TCFG, loop=loop)
        pix, samp = trender._lane_ids(torch.arange(W * H), SPP)
        rad = trender.lane_radiance(merge(leaves), pix, samp, width=W,
                                    height=H, cfg=cfg)
        return rad, tdiff._grads(leaves, torch.autograd.grad(
            rad.sum(), tdiff._flat(leaves), allow_unused=True))

    rad_s, gs = grads("scan")
    rad_w, gw = grads("while")
    assert torch.equal(rad_s, rad_w)
    for key in (("materials", "albedo"), ("materials", "ior"),
                ("lights", "intensity"), ("geometry", "tri_v0"),
                ("camera", "position")):
        g, f = key
        assert gs[g][f].abs().max() > 0, key
        torch.testing.assert_close(gs[g][f], gw[g][f], rtol=1e-6, atol=0)


def test_scan_refuses_the_resumable_form(scenes):
    ts = scenes["simple"][1]
    o = torch.zeros(4, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    ids = torch.arange(4)
    cfg = dataclasses.replace(TCFG, loop="scan")
    with pytest.raises(ValueError, match="resumable"):
        ttrace.trace(ts, o, d, ids, ids, cfg, end_bounce=1)
    with pytest.raises(ValueError, match="unknown loop"):
        ttrace.trace(ts, o, d, ids, ids,
                     dataclasses.replace(TCFG, loop="fori"))


# ---------------------------------------------------------------------------
# The finite-difference gates of tests/test_diff.py, for the port
# ---------------------------------------------------------------------------

def _fd(scene, group, field, index, eps, cfg=TCFG):
    return tdiff.finite_difference_grad(
        scene, W, H, samples=SPP, cfg=cfg, group=group, field=field,
        index=index, eps=eps)


def _check(g_ad, g_fd, rtol=2e-2, atol=1e-4):
    assert np.isfinite(g_ad) and np.isfinite(g_fd)
    np.testing.assert_allclose(g_ad, g_fd, rtol=rtol, atol=atol)


@pytest.mark.parametrize("group,field,index,eps,rtol", [
    ("materials", "albedo", (0, 0), 1e-3, 2e-2),
    ("materials", "albedo", (0, 2), 1e-3, 2e-2),
    ("lights", "intensity", (0,), 1e-3, 2e-2),
    ("lights", "position", (0, 1), 1e-3, 5e-2),
])
def test_simple_grad_vs_fd(scenes, both, group, field, index, eps, rtol):
    g = both["simple"][1][1]
    _check(float(g[group][field][index]),
           _fd(scenes["simple"][1], group, field, index, eps), rtol=rtol)


def test_grad_sphere_radius_vs_fd(scenes, both):
    """Same sign and order of magnitude: the FD straddles the silhouette,
    which pathwise AD does not see (tests/test_diff.py's gate)."""
    g = both["simple"][1][1]
    g_ad = float(g["geometry"]["sph_radius"][0])
    g_fd = _fd(scenes["simple"][1], "geometry", "sph_radius", (0,), 1e-4)
    assert np.isfinite(g_ad) and np.isfinite(g_fd)
    assert abs(g_ad - g_fd) < 0.5 * max(1.0, abs(g_fd))
    assert np.isfinite(g["geometry"]["sph_center"]).all()


@pytest.mark.parametrize("group,field,index,eps,rtol,atol,floor", [
    ("geometry", "tri_v0", (4, 2), 2e-4, 8e-2, 1e-4, 1e-3),
    ("geometry", "tri_v1", (4, 2), 2e-4, 8e-2, 1e-4, 1e-3),
    ("materials", "ior", (1,), 2e-3, 1.5e-1, 2e-4, 1e-4),
    ("camera", "position", (0,), 2e-4, 8e-2, 1e-4, 1e-3),
    ("camera", "position", (1,), 2e-4, 8e-2, 1e-4, 1e-3),
    ("camera", "position", (2,), 2e-4, 8e-2, 1e-4, 1e-3),
])
def test_cube_grad_vs_fd(scenes, both, group, field, index, eps, rtol, atol,
                         floor):
    g = both["cube"][1][1]
    g_ad = float(g[group][field][index])
    g_fd = _fd(scenes["cube"][1], group, field, index, eps)
    assert np.isfinite(g_ad) and np.isfinite(g_fd)
    assert abs(g_fd) > floor, "fixture regressed: gradient is vacuous"
    np.testing.assert_allclose(g_ad, g_fd, rtol=rtol, atol=atol)


def test_grad_vs_fd_deeper_depth(scenes):
    ts = scenes["cube"][1]
    cfg6 = ttrace.TraceConfig(max_depth=6, shadow_samples=2)
    _, g = tdiff.render_and_grad(ts, W, H, samples=SPP, cfg=cfg6)
    g_fd = _fd(ts, "materials", "albedo", (0, 0), 1e-3, cfg6)
    assert abs(g_fd) > 1e-2
    np.testing.assert_allclose(float(g["materials"]["albedo"][0, 0]), g_fd,
                               rtol=2e-2, atol=1e-4)
    gi_fd = _fd(ts, "materials", "ior", (1,), 2e-3, cfg6)
    assert abs(gi_fd) > 1e-4
    np.testing.assert_allclose(float(g["materials"]["ior"][1]), gi_fd,
                               rtol=1.5e-1, atol=2e-4)


def test_grad_at_1k_prims_vs_fd():
    """grid-1001 (the JAX test's 1,000-sphere scene), brute force."""
    s = tscene.from_dict(suite.grad_grid_scene_dict(), device="cpu")[0]
    assert s.geometry.sph_center.shape[0] == 1000
    cfg = ttrace.TraceConfig(max_depth=2, shadow_samples=1)
    w, h, spp = 10, 8, 1
    img, g = tdiff.render_and_grad(s, w, h, samples=spp, cfg=cfg)
    assert float(img.max()) > 0.0
    assert all(bool(torch.isfinite(v).all())
               for sub in g.values() for v in sub.values())
    fd = tdiff.finite_difference_grad(
        s, w, h, samples=spp, cfg=cfg, group="lights", field="intensity",
        index=(0,), eps=0.1)
    _check(float(g["lights"]["intensity"][0]), fd)


# ---------------------------------------------------------------------------
# keep_accel: the walk without autograd, the winner's t straight-through
# ---------------------------------------------------------------------------

def test_grad_through_accel_frozen_geometry():
    s = tscene.from_dict(ring_dict(True, 2.0, [4, 8, 4]), device="cpu")[0]
    assert s.accel is not None
    cfg = ttrace.TraceConfig(max_depth=2, shadow_samples=1)
    kw = dict(samples=1, cfg=cfg)
    img_a, g_a = tdiff.render_and_grad(s, W, H, keep_accel=True, **kw)
    img_b, g_b = tdiff.render_and_grad(s, W, H, **kw)
    assert float(img_a.max()) > 0.0
    assert torch.equal(img_a, img_b)
    for grp in ("materials", "lights"):
        for f, va in g_a[grp].items():
            assert bool(torch.isfinite(va).all()), (grp, f)
            torch.testing.assert_close(va, g_b[grp][f], rtol=1e-3,
                                       atol=1e-6, msg=f"{grp}.{f}")


def test_inverse_rendering_converges_through_accel():
    s = tscene.from_dict(ring_dict(False, 60.0, [2, 5, -2]),
                         device="cpu")[0]
    assert s.accel is not None
    cfg = ttrace.TraceConfig(max_depth=2, shadow_samples=1)
    w, h, spp = 12, 8, 1
    params, merge = tdiff.split_params(s, keep_accel=True)
    with torch.no_grad():
        target = tdiff.render_image(merge(params), w, h, spp, cfg)
    norm = torch.mean(target ** 2) + 1e-12

    def loss_grad(scale):
        sc = torch.tensor(scale, requires_grad=True)
        p2 = dict(params, lights=dict(params["lights"],
                                      intensity=s.lights.intensity * sc))
        img = tdiff.render_image(merge(p2), w, h, spp, cfg)
        loss = torch.mean((img - target) ** 2) / norm
        return float(loss.detach()), float(torch.autograd.grad(loss, sc)[0])

    scale = 0.4
    l0, _ = loss_grad(scale)
    for _ in range(60):
        _, g = loss_grad(scale)
        scale = scale - 0.5 * g
    l_end, _ = loss_grad(scale)
    assert l0 > 1e-3
    assert l_end < l0 / 100, (l0, l_end)
    np.testing.assert_allclose(scale, 1.0, atol=0.05)


# ---------------------------------------------------------------------------
# Inverse rendering, the optimizer, the guards
# ---------------------------------------------------------------------------

def test_inverse_rendering_recovers_light_intensity(scenes):
    """tests/test_diff.py's: intensity tripled, 250 Adam steps (lr 5e-2)
    on the MSE to the original image."""
    ts = scenes["simple"][1]
    with torch.no_grad():
        target = tdiff.render_image(ts, W, H, SPP, TCFG)
    true_int = ts.lights.intensity.clone()
    bad = dataclasses.replace(ts, lights=dataclasses.replace(
        ts.lights, intensity=true_int * 3.0))
    state, step = tdiff.make_train_step(
        bad, target, width=W, height=H, samples=SPP, cfg=TCFG,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=5e-2),
        trainable={"lights.intensity"})
    losses = []
    for _ in range(250):
        state, loss = step(state)
        losses.append(float(loss))
    assert state.step == 250
    assert losses[-1] < 0.02 * losses[0], (losses[0], losses[-1])
    rec = state.params["lights"]["intensity"].detach()
    torch.testing.assert_close(rec, true_int, rtol=0.1, atol=0)
    # only the trainable field moved; the scene's own tensors did not
    assert torch.equal(state.params["materials"]["albedo"].detach(),
                       bad.materials.albedo)
    assert torch.equal(bad.lights.intensity, true_int * 3.0)


def test_default_optimizer_is_optax_adam(scenes):
    """make_train_step's default optimizer against optax.adam(1e-2) on the
    same 5 gradients (random, from a seed) from the same parameters:
    within rtol 1e-5, atol 1e-6 (1e-4 of the step size: optax rounds
    beta2 to float32, which puts its bias correction 1.3e-5 off at the
    first step, and a parameter that starts at 0 is only its sum of
    steps)."""
    import optax
    ts = scenes["cube"][1]
    state, _ = tdiff.make_train_step(ts, np.zeros((H, W, 3), np.float32),
                                     width=W, height=H, samples=SPP,
                                     cfg=TCFG)
    opt = state.opt_state
    assert isinstance(opt, torch.optim.Adam)
    jp = {g: {f: np.asarray(v.detach()) for f, v in sub.items()}
          for g, sub in state.params.items()}
    jopt = optax.adam(1e-2)
    jstate = jopt.init(jp)
    rng = np.random.default_rng(0)
    for _ in range(5):
        grads = {g: {f: rng.standard_normal(v.shape).astype(np.float32)
                     for f, v in sub.items()} for g, sub in jp.items()}
        upd, jstate = jopt.update(grads, jstate, jp)
        jp = np_tree(optax.apply_updates(jp, upd))
        for g, sub in state.params.items():
            for f, t in sub.items():
                t.grad = torch.from_numpy(grads[g][f])
        opt.step()
    for g, sub in state.params.items():
        for f, t in sub.items():
            np.testing.assert_allclose(t.detach().numpy(), jp[g][f],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{g}.{f}")


def test_resume_from_jax_params(scenes):
    """The JAX package trains 3 steps; its TrainState.params carried
    across (convert.params_from_numpy) into the port's train state render
    the JAX image of those parameters within atol 1e-5."""
    import optax
    js, ts = scenes["simple"]
    target = np.zeros((H, W, 3), np.float32)
    jstate, jstep = jdiff.make_train_step(
        js, target, width=W, height=H, samples=SPP, cfg=JCFG,
        optimizer=optax.adam(5e-2), trainable={"lights.intensity"})
    for _ in range(3):
        jstate, _ = jstep(jstate)
    jp = np_tree(jstate.params)
    _, jmerge = jdiff.split_params(js)
    jimg = np.asarray(jdiff.render_image(jmerge(jstate.params), W, H, SPP,
                                         JCFG))
    state, step = tdiff.make_train_step(ts, target, width=W, height=H,
                                        samples=SPP, cfg=TCFG)
    carried = convert.params_from_numpy(jp, device="cpu")
    with torch.no_grad():
        for g, sub in state.params.items():
            for f, t in sub.items():
                t.copy_(carried[g][f])
    _, tmerge = tdiff.split_params(ts)
    with torch.no_grad():
        timg = tdiff.render_image(tmerge(state.params), W, H, SPP, TCFG)
    assert not np.allclose(jp["lights"]["intensity"],
                           np.asarray(js.lights.intensity))
    np.testing.assert_allclose(timg.numpy(), jimg, rtol=0, atol=1e-5)
    state, loss = step(state)
    assert np.isfinite(float(loss))


def test_tangent_ray_gives_finite_gradients():
    """A ray exactly tangent to a sphere (disc == 0 in sphere_t) is a hit;
    its root's derivative is infinite, and without the guard reverse
    mode carries NaN into the sphere's gradients."""
    d = {"camera": {"position": [0, 0, 5], "aspectRatio": 1.0},
         "objects": [{"type": "sphere", "position": [0, 0, 0],
                      "radius": 1.0,
                      "material": {"type": "lambertian",
                                   "color": [0.5, 0.5, 0.5]}}],
         "lights": [{"type": "point", "position": [0, 5, 5],
                     "color": [1, 1, 1], "intensity": 2.0}]}
    s = tscene.from_dict(d, device="cpu")[0]
    params, merge = tdiff.split_params(s)
    leaves = tdiff._leaves(params)
    # the tangent lane, and a lane through the sphere's middle
    o = torch.tensor([[1.0, 0.0, 5.0], [0.25, 0.0, 5.0]])
    dirs = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    ids = torch.arange(2)
    cfg = dataclasses.replace(TCFG, loop="scan")
    rad = ttrace.trace(merge(leaves), o, dirs, ids, ids, cfg)
    assert float(rad[0].sum().detach()) > 0  # the tangent lane hit
    g = tdiff._grads(leaves, torch.autograd.grad(
        rad.sum(), tdiff._flat(leaves), allow_unused=True))
    for grp, sub in g.items():
        for f, v in sub.items():
            assert bool(torch.isfinite(v).all()), (grp, f)
    assert float(g["geometry"]["sph_radius"].abs().max()) > 0


def test_mesh_is_refused(scenes):
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tdiff.make_train_step(scenes["simple"][1],
                              np.zeros((H, W, 3), np.float32), width=W,
                              height=H, samples=SPP, cfg=TCFG,
                              mesh=object())


def test_tools_at_a_small_size():
    """measure_grad_scale's rows (grid-1001 at 8x6, both paths: the FD
    check, keep_accel = brute) and inverse_rendering's loop (5 steps: the
    loss falls), on the CPU."""
    s = tscene.from_dict(suite.grad_grid_scene_dict(), device="cpu")[0]
    kw = dict(width=8, height=6, samples=1, reps=1)
    brute = measure_grad_scale.measure_row("grid-1001", s, False, **kw)
    accel = measure_grad_scale.measure_row("grid-1001", s, True, **kw)
    assert brute["bounces"] == 3 and brute["bounces_rerun"] == 3
    assert brute["peak_bytes"] is None  # no device memory on the CPU
    assert measure_grad_scale.accel_agrees(accel, brute) <= 1e-3
    assert "not measured" in measure_grad_scale.line(brute)
    out = inverse_rendering.run(steps=5, device="cpu")
    assert out["losses"][-1] < out["losses"][0]
    assert out["device"] == "cpu"
