"""Inverse rendering: recover a light's intensity from a target image
(the port of ``examples/inverse_rendering.py``).

    python -m raytrace_tpu_torch.tools.inverse_rendering [--steps 200]
        [--device cpu]

Renders the ground truth of a one-sphere scene at 16x16, 2 spp, depth 3,
2 shadow samples, triples the light's intensity, and descends on the
pixel MSE with Adam (lr 5e-2) through the whole path tracer, only the
intensity trainable. Prints the loss and the intensity every 25 steps
and exits 0 when the recovered intensity is within 10% of the truth. Runs
on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import time

import torch

from .. import _device, diff
from .. import scene as scene_mod
from .. import trace as trace_mod

SCENE = {
    "camera": {"position": [0, 0, 3], "aspectRatio": 1.0},
    "objects": [{"type": "sphere", "position": [0, 0, 0], "radius": 1.0,
                 "material": {"type": "lambertian",
                              "color": [0.6, 0.3, 0.2]}}],
    "lights": [{"type": "point", "position": [0, 5, 5],
                "color": [1, 1, 1], "intensity": 2.0}],
}
W, H, SPP = 16, 16, 2
CFG = trace_mod.TraceConfig(max_depth=3, shadow_samples=2)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def intensity(state):
    """The light's intensity in a train state."""
    return state.params["lights"]["intensity"].detach()[0]


def run(steps: int = 200, device=None, log=None) -> dict:
    """Run the descent: {"losses" (one a step), "ms_per_step" (host clock
    over the whole loop, synchronised), "recovered", "true", "rel_err",
    "device"}. ``log(i, loss, intensity)`` is called every 25 steps and at
    the last one."""
    device = _device.resolve(device)
    scene = scene_mod.from_dict(SCENE, device=device)[0]
    with torch.no_grad():
        target = diff.render_image(scene, W, H, SPP, CFG)
    true = float(scene.lights.intensity[0])
    bad = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, intensity=scene.lights.intensity * 3.0))
    state, step = diff.make_train_step(
        bad, target, width=W, height=H, samples=SPP, cfg=CFG,
        optimizer=functools.partial(torch.optim.Adam, lr=5e-2),
        trainable={"lights.intensity"})
    losses = []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        state, loss = step(state)
        losses.append(loss)
        if log is not None and (i % 25 == 0 or i == steps - 1):
            log(i, float(loss), float(intensity(state)))
    _sync(device)
    seconds = time.perf_counter() - t0
    rec = float(intensity(state))
    return {"losses": [float(x) for x in losses],
            "ms_per_step": 1e3 * seconds / max(steps, 1),
            "recovered": rec, "true": true,
            "rel_err": abs(rec - true) / true, "device": str(device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    def log(i, loss, rec):
        print(f"step {i:4d}  loss {loss:.3e}  intensity {rec:.4f}",
              flush=True)

    out = run(args.steps, args.device, log=log)
    print(f"recovered intensity {out['recovered']:.4f} (true "
          f"{out['true']}), relative error {out['rel_err']:.2%}, "
          f"{out['ms_per_step']:.2f} ms a step on {out['device']}")
    return 0 if out["rel_err"] < 0.1 else 1


if __name__ == "__main__":
    sys.exit(main())
