"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Every ``.cu`` under ``raytrace_tpu_torch/csrc`` is compiled by its own nvcc
process, all started together, and the objects are linked into one shared
library with a plain C interface: no PyTorch headers, so the build takes
seconds, not minutes. The library lands in
``raytrace_tpu_torch/_build/`` (listed in .gitignore) under a name keyed by
a hash of the sources and flags, so the first use in a fresh checkout
builds it and later uses load it. Nothing is built at import.

Flags: sm_90a (Hopper), -fmad=false (no FMA contraction, so the kernels
round as the plain PyTorch versions do) and no fast math (IEEE division
and square root). ``-Xptxas -v`` reports registers, shared memory and
spills; ``build()`` returns that report.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: str            # the shared library
    built: bool          # False when a library with this key existed
    seconds: float       # nvcc wall time (0 when not built)
    ptxas: List[str]     # the -Xptxas -v report lines


def _sources() -> List[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile every .cu under csrc into one library, unless it exists."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    key = _key()
    lib = os.path.join(BUILD_DIR, f"librt_kernels_{key}.so")
    log = lib + ".ptxas.txt"
    if os.path.exists(lib):
        ptxas = open(log).read().splitlines() if os.path.exists(log) else []
        return BuildResult(lib, False, 0.0, ptxas)
    tmp = f"{lib}.{os.getpid()}.tmp"
    srcs = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc()] + NVCC_FLAGS + ["-c", "-o", o, s],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    report = []
    try:
        for src, proc in zip(srcs, procs):
            text = proc.communicate(timeout=600)[0]
            report.append(text)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"({proc.returncode}):\n{text}")
        link = subprocess.run([_nvcc(), "-shared", "-o", tmp] + objs,
                              capture_output=True, text=True, timeout=600)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in "".join(report).splitlines()
             if "ptxas" in ln or "spill" in ln]
    with open(log, "w") as f:
        f.write("\n".join(ptxas))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return BuildResult(lib, True, seconds, ptxas)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(build().path)
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    dims = ctypes.POINTER(ctypes.c_int)  # bounce.cuh:Dims
    # origin, direction, pix, samp, tp_in, alive_in, radiance, state,
    # counters, n_lanes, tables, dims (bounce.cuh:Lanes, Dims)
    lanes = [p] * 9 + [i, p, dims]
    f = ctypes.c_float
    # start_bounce, end_bounce, shadow_samples, soft, recursive, seed,
    # rr_start, tp_eps, soft_guard, stream (bounce.cuh:Run)
    run = [i, i, i, i, i, u, i, f, i, p]
    # after the dims: rt_trace_unroll the lane counter; rt_trace_bvh the
    # walk table, its floats, in shared memory, the lane counter;
    # rt_trace_stream the stream table; rt_trace_loop in shared memory,
    # the lane counter
    for name, extra in (("rt_trace_unroll", [p]),
                        ("rt_trace_bvh", [p, i, i, p]),
                        ("rt_trace_stream", [p]),
                        ("rt_trace_loop", [i, p])):
        fn = getattr(lib, name)
        fn.argtypes = lanes + extra + run
        fn.restype = i
    # P1: table, n_rows, row_floats, n_steps, seed, variant, out, stream
    lib.rt_dma_probe.argtypes = [p, i, i, i, i, i, p, p]
    lib.rt_dma_probe.restype = i
    # the camera of a mask launch (pixel_mask.cu: RT_MASK_CAM_ARGS):
    # position, look_at, up, fov, aspect, go, dof, lens, focus
    cam = [p] * 5 + [i, i, f, f]
    # the scene's arrays of a mask table (RT_MASK_SCENE_ARGS): node_min,
    # node_max, skip, first, count, n_nodes, prim_index, n_slots,
    # sph_center, sph_radius, ns, v0, v1, v2
    mask_scene = [p] * 5 + [i, p, i, p, p, i, p, p, p]
    # out, width, height, row0, band (the rows written), inv_w, inv_h, cam
    head = [p, i, i, i, i, f, f] + cam
    planes = [p, p, i]            # pl_point, pl_normal, npl
    # K2: rows a chunk; K6 and K6-stream: the mask table, its floats, in
    # shared memory
    for name, args in (("rt_pixel_mask", [i]),
                       ("rt_pixel_mask_bvh", [p, i, i]),
                       ("rt_pixel_mask_stream", [p, i, i])):
        fn = getattr(lib, name)
        fn.argtypes = head + args + planes + mask_scene + [p]
        fn.restype = i
    # the pre-pass: tab, width, height, the camera, the scene's arrays;
    # the camera row alone: row, width, height, the camera
    lib.rt_mask_table.argtypes = [p, i, i] + cam + mask_scene + [p]
    lib.rt_mask_table.restype = i
    lib.rt_mask_camera.argtypes = [p, i, i] + cam + [p]
    lib.rt_mask_camera.restype = i
    return lib


def kernel_resources(lines) -> dict:
    """{kernel entry: (registers, stack bytes, spill bytes)} from a
    ``-Xptxas -v`` report (``BuildResult.ptxas``)."""
    out, cur = {}, None
    for ln in lines:
        m = re.search(r"(?:entry function|Function properties for) '?"
                      r"([A-Za-z_]\w*)", ln)
        if m:
            cur = m.group(1)
            out.setdefault(cur, [None, 0, 0])
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[cur][1] = int(m.group(1))
            out[cur][2] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
