"""The optimisation demo (port of ``raytrace_tpu/bench/optimization_demo.py``):

  1. a fast-math printout;
  2. a BVH, an Octree and a KD-tree over random spheres, the naive
     closest hit against the BVH walk (both plain PyTorch on the device,
     timed with a synchronise), and the host trees' ray queries;
  3. a benchmark-suite run of the ring scene;
  4. a render that reports the BVH build time.

    python -m raytrace_tpu_torch.bench.optimization_demo [--device cpu]

The device is ``cuda`` by default; the trees are built, and the Octree
and KD-tree queried, on the host. ``--spheres``, ``--rays``, ``--width``
and ``--height`` shrink the demo (for a CPU run).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def demo_fast_math() -> None:
    from .. import fastmath as fm
    print("=== fast math ===")
    x = torch.tensor([2.0, 16.0, 0.5])
    print("sqrt:", fm.fast_sqrt(x).tolist())
    print("rsqrt:", fm.fast_inv_sqrt(x).tolist())
    print("smoothstep(0,1,0.3):", float(fm.fast_smooth_step(0.0, 1.0, 0.3)))
    r = fm.FastRandom(42)
    print("xorshift64* x3:", [f"{r.float64():.6f}" for _ in range(3)])


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def demo_spatial(n_spheres: int = 1000, n_rays: int = 4096,
                 device=None) -> dict:
    """The trees over ``n_spheres`` random spheres and ``n_rays`` random
    rays: build times, the naive closest hit (every ray against every
    sphere) and the BVH walk, each timed once after a warm-up call, and
    the host trees' candidates a ray."""
    from .. import _device
    from .. import bvh as bvh_mod
    from ..ops import intersect
    dev = _device.resolve(device)
    print(f"=== spatial acceleration over {n_spheres} spheres ===")
    rng = np.random.default_rng(0)
    centers = rng.uniform(-50, 50, (n_spheres, 3)).astype(np.float32)
    radii = rng.uniform(0.2, 1.5, n_spheres).astype(np.float32)

    t0 = time.perf_counter()
    tree = bvh_mod.build_sphere_bvh(centers, radii, device=dev)
    bvh_build_s = time.perf_counter() - t0
    print(f"BVH: {tree.n_nodes} nodes in {bvh_build_s * 1e3:.2f} ms")
    lo = centers - radii[:, None]
    hi = centers + radii[:, None]
    t0 = time.perf_counter()
    octree = bvh_mod.Octree(lo, hi)
    print(f"Octree: {octree.node_count()} nodes "
          f"in {(time.perf_counter() - t0) * 1e3:.2f} ms")
    t0 = time.perf_counter()
    kd = bvh_mod.KDTree(lo, hi)
    print(f"KD-tree: depth {kd.depth()} "
          f"in {(time.perf_counter() - t0) * 1e3:.2f} ms")

    o = rng.uniform(-60, 60, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    ot, dt_, ct, rt = (torch.from_numpy(a).to(dev)
                       for a in (o, d, centers, radii))

    def time_it(f):
        f()  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        f()
        _sync(dev)
        return time.perf_counter() - t0

    naive_s = time_it(lambda: intersect.sphere_t(
        ot, dt_, ct, rt, 1e-3, intersect.BIG).amin(dim=1))
    bvh_s = time_it(lambda: bvh_mod.closest_hit_bvh(tree, ct, rt, ot,
                                                    dt_)[0])
    print(f"naive closest-hit: {naive_s * 1e3:.2f} ms; "
          f"BVH: {bvh_s * 1e3:.2f} ms "
          f"({naive_s / max(bvh_s, 1e-9):.1f}x) on {dev}")

    sub = min(64, n_rays)
    t0 = time.perf_counter()
    oc_cands = [len(octree.query_ray(o[i], d[i])) for i in range(sub)]
    oc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kd_cands = [len(kd.query_ray(o[i], d[i])) for i in range(sub)]
    kd_s = time.perf_counter() - t0
    print(f"octree ray query: {np.mean(oc_cands):.1f} candidates/ray "
          f"(vs {n_spheres} naive), {oc_s / sub * 1e3:.2f} ms/ray; "
          f"kd: {np.mean(kd_cands):.1f}, {kd_s / sub * 1e3:.2f} ms/ray")
    return {"bvh_build_seconds": bvh_build_s, "naive_seconds": naive_s,
            "bvh_seconds": bvh_s, "bvh_nodes": tree.n_nodes}


def demo_benchmark_suite(width: int = 200, height: int = 150,
                         device=None) -> None:
    from .suite import BenchmarkConfig, BenchmarkSuite
    print("=== benchmark suite (ring scene) ===")
    suite = BenchmarkSuite(BenchmarkConfig(
        width=width, height=height, samples_list=(4,), max_depth=10,
        repetitions=2, warmup=1), device=device)
    suite.run()
    suite.print_table()


def demo_optimized_render(width: int = 200, height: int = 150,
                          device=None) -> None:
    from .. import bvh as bvh_mod
    from .. import renderer as renderer_mod
    from .. import scene as scene_mod
    from .suite import ring_scene_dict
    print("=== optimized render with BVH metrics ===")
    r = renderer_mod.Renderer(device=device)
    scene, _ = scene_mod.from_dict(ring_scene_dict(n_spheres=10),
                                   device=r.device)
    g = scene.geometry
    t0 = time.perf_counter()
    bvh_mod.build_sphere_bvh(g.sph_center.cpu().numpy(),
                             g.sph_radius.cpu().numpy())
    bvh_build_s = time.perf_counter() - t0
    r.set_samples(4)
    r.set_max_depth(10)
    t0 = time.perf_counter()
    r.render_linear(scene, width, height)
    render_s = time.perf_counter() - t0
    print(f"bvh_build_time: {bvh_build_s * 1e6:.1f} us; "
          f"render: {render_s:.3f} s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rt-optimization-demo")
    p.add_argument("--device", default="cuda")
    p.add_argument("--spheres", type=int, default=1000)
    p.add_argument("--rays", type=int, default=4096)
    p.add_argument("--width", type=int, default=200)
    p.add_argument("--height", type=int, default=150)
    args = p.parse_args(argv)
    demo_fast_math()
    demo_spatial(args.spheres, args.rays, device=args.device)
    demo_benchmark_suite(args.width, args.height, device=args.device)
    demo_optimized_render(args.width, args.height, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
