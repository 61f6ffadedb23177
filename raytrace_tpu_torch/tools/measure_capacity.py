"""Frame times of the capacity path against another copy of the package,
on the card: ``Renderer.render``'s bench frame (800x600, 100 spp, depth
50, 16 soft-shadow rays) on the bench scene, ring-1000 and the loop frame
(the icosphere golden without its BVH), and, where the package has the
speculative capacity path, the fused frame (``assume_capacity`` and one
``flush_capacity_checks``) at the cached, padded capacity and at the
exact hit count, which is what the padding slots cost. Every frame is
timed alone on the host clock, synchronised. One process a package:
compare two copies in one machine, in turns (A, B, B, A):

    python3 raytrace_tpu_torch/tools/measure_capacity.py DIR LABEL

DIR holds the ``raytrace_tpu_torch`` package to time (``.`` for this
checkout; a parent commit's unpacked into a git-ignored directory with
``assets/icosphere.obj`` beside it); the last line printed is ``AB`` and
a JSON object of the medians and every time. AB_DEVICE=cpu and
AB_SIZE=W,H,SPP rehearse it on the CPU at a small size.
"""

import json
import os
import statistics
import sys
import time

# the bench scene comes from this checkout's assets
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")
REPS = {"bench": 30, "ring1000": 5, "loop": 5}


def measure(pkg_dir: str, label: str) -> dict:
    sys.path.insert(0, os.path.abspath(pkg_dir))
    import torch
    from raytrace_tpu_torch import renderer as rmod
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.bench.suite import (bvh_scene_dict,
                                                 golden_scene_dict)
    from raytrace_tpu_torch.ops import _build
    if not rmod.__file__.startswith(os.path.abspath(pkg_dir)):
        raise RuntimeError(f"imported {rmod.__file__}, not from {pkg_dir}")
    dev = torch.device(os.environ.get("AB_DEVICE", "cuda"))
    if dev.type == "cuda":
        _build.build()
    W, H, SPP = (int(x) for x in
                 os.environ.get("AB_SIZE", "800,600,100").split(","))
    with open(os.path.join(ASSETS, "sphere_reflections_light.json")) as f:
        d = json.load(f)
    d["camera"]["position"][2] = -d["camera"]["position"][2]
    scenes = {
        "bench": scene_mod.from_dict(d, device=dev)[0],
        "ring1000": scene_mod.from_dict(bvh_scene_dict("ring1000"),
                                        device=dev)[0],
        "loop": scene_mod.from_dict(
            golden_scene_dict("mesh_smooth_icosphere")[0], device=dev,
            build_accel=False)[0]}
    r = rmod.Renderer(device=dev)
    r.set_samples(SPP)
    r.set_max_depth(50)
    cfg = r.trace_config()
    kw = dict(width=W, height=H, samples=SPP, cfg=cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def times(fn, n):
        out = []
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    res = {"label": label, "card": (torch.cuda.get_device_name(0)
                                    if dev.type == "cuda" else "cpu")}
    for name, s in scenes.items():
        n = REPS[name]
        if hasattr(rmod, "_KPAD_CACHE"):
            rmod._KPAD_CACHE.clear()
        r.render(s, W, H)
        r.render(s, W, H)
        row = {"render": times(lambda: r.render(s, W, H), n)}
        if hasattr(rmod, "flush_capacity_checks"):
            key = rmod.capacity_key(W, H, SPP, cfg, True, None, s.device)
            k_pad = rmod._KPAD_CACHE[key]
            _, pos = rmod._pixel_mask(s, width=W, height=H, cfg=cfg,
                                      go_camera=True)
            k = int(pos[-1]) + 1

            def fused():
                rmod.render_wavefront(s, assume_capacity=True, **kw)
                rmod.flush_capacity_checks()

            for cap, tag in ((k_pad, "fused_padded"), (k, "fused_exact"),
                             (k_pad, "fused_padded2")):
                rmod._KPAD_CACHE[key] = cap
                fused()
                row[tag] = times(fused, n)
            row.update(k=k, k_pad=k_pad)
        res[name] = {t: (statistics.median(v) if isinstance(v, list) else v)
                     for t, v in row.items()}
        res[name]["all"] = {t: [round(x, 3) for x in v]
                            for t, v in row.items() if isinstance(v, list)}
    return res


if __name__ == "__main__":
    print("AB " + json.dumps(measure(sys.argv[1], sys.argv[2])), flush=True)
