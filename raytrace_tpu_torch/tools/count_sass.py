"""SASS instruction counts of the brute-force tests K1 and K7 run, for
weighing the operation counts of chip_smoke.py's bounds against what the
card executes.

    python -m raytrace_tpu_torch.tools.count_sass [--out FILE]

chip_smoke.py's bounds (``k1_ops``) count every add, multiply, compare,
divide and square root of a test as one operation: 25 for a sphere
(``sphere_t``), 54 for a triangle (``triangle_t``). Built as the kernels
are (``_build.NVCC_FLAGS``: sm_90a, -fmad=false, IEEE division and square
root), a divide or a square root is a sequence of instructions with a
slow path for special operands. This tool compiles a probe of each test -
a kernel that loads the test's inputs, runs it once and stores its result
- beside a baseline kernel that asks for the same inputs without the test
(ptxas drops those loads, so the difference holds the test's loads of its
inputs, LDG, which the by-opcode counts show apart), disassembles both
with ``cuobjdump -sass`` and prints, for each test, the difference in
static SASS instructions (all of them, and by opcode), with the card's
name and power limit. Static counts: a slow path that the data never
takes is counted, a loop is counted once. Needs nvcc and cuobjdump (the
CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from ..ops import _build
from .measure_dma_stream import card

PROBE = r"""
#include "common.cuh"

__device__ __forceinline__ void keep(float v) { asm volatile("" ::"f"(v)); }

extern "C" __global__ void probe_sphere_t(const float* in, float* out) {
  rt::V3 o{in[0], in[1], in[2]}, d{in[3], in[4], in[5]};
  out[threadIdx.x] = rt::sphere_t(o, d, in[6], in[7], in + 8, in[12]);
}

extern "C" __global__ void base_sphere_t(const float* in, float* out) {
  for (int k = 0; k < 13; ++k) keep(in[k]);
  out[threadIdx.x] = 0.0f;
}

extern "C" __global__ void probe_triangle_t(const float* in, float* out) {
  rt::V3 o{in[0], in[1], in[2]}, d{in[3], in[4], in[5]};
  out[threadIdx.x] = rt::triangle_t(o, d, in + 6, in[15]);
}

extern "C" __global__ void base_triangle_t(const float* in, float* out) {
  for (int k = 0; k < 16; ++k) keep(in[k]);
  out[threadIdx.x] = 0.0f;
}
"""
TESTS = ("sphere_t", "triangle_t")
# The operations chip_smoke.py's bounds count a test (k1_ops).
COUNTED = {"sphere_t": 25, "triangle_t": 54}


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.path.dirname(_build._nvcc()), name)
    if os.path.exists(path):
        return path
    raise RuntimeError(f"{name} not found")


def sass_by_kernel(cubin: str) -> dict:
    """{kernel: [opcode, ...]} from ``cuobjdump -sass``."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+"     # the address
                     r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return out


def count() -> dict:
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-Xptxas", "-v", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        subprocess.run([_build._nvcc()] + flags + ["-I", _build.CSRC,
                                                   "-cubin", "-o", cubin,
                                                   src],
                       check=True, capture_output=True, text=True)
        sass = sass_by_kernel(cubin)
    rows = {}
    for test in TESTS:
        probe = collections.Counter(op.split(".")[0]
                                    for op in sass[f"probe_{test}"])
        base = collections.Counter(op.split(".")[0]
                                   for op in sass[f"base_{test}"])
        diff = {op: probe[op] - base[op]
                for op in sorted(set(probe) | set(base))
                if probe[op] != base[op]}
        rows[test] = dict(sass=len(sass[f"probe_{test}"])
                          - len(sass[f"base_{test}"]),
                          probe=len(sass[f"probe_{test}"]),
                          baseline=len(sass[f"base_{test}"]),
                          counted_ops=COUNTED[test], by_opcode=diff)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    report = {"card": card(), "flags": _build.NVCC_FLAGS, "tests": count()}
    text = json.dumps(report)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
