"""Command line: render a scene JSON to a PNG with the port.

    python -m raytrace_tpu_torch.cli scene.json out.png W H --samples N
        [--max-depth D] [--seed S] [--no-soft-shadows]
        [--no-recursive-reflections] [--fast-mc] [--lookat-camera]
        [--go-parity] [--ascii-preview] [--device cuda|cpu]

Runs on the GPU unless ``--device cpu`` is given; without a GPU the
default raises. Writes the PNG and ``benchmark_data.json`` beside it.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import renderer as renderer_mod
from . import scene as scene_mod


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer",
        description="path tracer on PyTorch and CUDA (reference-parity CLI)")
    p.add_argument("scene_file")
    p.add_argument("output_file")
    p.add_argument("width", type=int)
    p.add_argument("height", type=int)
    p.add_argument("--samples", type=int, default=100)
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-soft-shadows", action="store_true")
    p.add_argument("--no-recursive-reflections", action="store_true")
    p.add_argument("--fast-mc", action="store_true",
                   help="expectation-preserving Monte Carlo accelerators: "
                        "Russian roulette from bounce 8 and a throughput "
                        "cutoff of 1e-4")
    p.add_argument("--lookat-camera", action="store_true",
                   help="honor lookAt/up/fov instead of the reference's "
                        "fixed-viewport camera")
    p.add_argument("--go-parity", action="store_true",
                   help="reproduce the reference loader (skip prisms and "
                        "planes, ignore the scene's renderer block)")
    p.add_argument("--ascii-preview", action="store_true",
                   help="print the image as ASCII art")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    r = renderer_mod.Renderer(device=args.device)
    print(f"Loading scene from: {args.scene_file}")
    try:
        scene, cfg = scene_mod.load(args.scene_file,
                                    go_parity=args.go_parity,
                                    device=r.device)
    except (OSError, ValueError, KeyError) as e:
        print(f"Error loading scene: {e}")
        return 1
    r.set_samples(args.samples)
    r.set_max_depth(args.max_depth)
    r.seed = args.seed
    if args.no_soft_shadows:
        r.set_soft_shadows(False)
    if args.no_recursive_reflections:
        r.set_recursive_reflections(False)
    r.fast_mc = args.fast_mc
    r.go_camera = not args.lookat_camera

    print(f"Rendering at {args.width}x{args.height} resolution...")
    img = r.render(scene, args.width, args.height,
                   scene_config=None if args.go_parity else cfg)
    out = args.output_file
    if not os.path.splitext(out)[1]:
        out += ".png"
    print(f"Saving to: {out}")
    r.save_image(img, out)
    r.save_benchmark_data(os.path.join(os.path.dirname(out) or ".",
                                       "benchmark_data.json"))
    print("Benchmark data saved")
    if args.ascii_preview:
        r.print_ascii_preview(img)
    return 0


if __name__ == "__main__":
    sys.exit(main())
