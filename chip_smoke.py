#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
the port builds, runs and agrees with itself on the card.

    python3 chip_smoke.py

Phases, in order (each prints a line before and after, with its seconds):

  env               card name and power limit, torch and CUDA versions
  build             one nvcc process for each source, all started
                    together, linked into one library; registers, shared
                    memory and spills from -Xptxas -v
  dma_probe         P1 (the dependent-row copy probe) through its tool's
                    measurement: the ld, cp_async and tma variants at the
                    TPU tool's shape (8192 x 128 floats, 2,000 steps), at
                    32-row leaf blocks of 23-float rows in the L2 and past
                    it, each equal to the plain chain bit for bit; ns a
                    step
  k2_check          K2 (pixel mask, brute force) against its plain version
                    at 800x600 on the three demo scenes, on the camera row
                    that the kernel builds (MaskLaunch.cam, rt_mask_camera)
                    and on _mask_camera's row computed by PyTorch on the
                    card, which must equal the kernel's bit for bit (both
                    cameras; the elements where the CPU's row differs are
                    printed in ulps): masks equal; K2 past its
                    shared-memory budget (lowered) at 160x120 on the bench
                    scene and the icosphere golden without its BVH; and
                    ring-2500 with and without its ground (loop mode,
                    2,501 and 2,500 bounding spheres) at 800x600, the plain
                    version going over the pixels in steps
  k1_check          K1 (bounce megakernel, unroll mode) against its plain
                    version on the lanes of a 64x48 frame, 4 spp, depth 50,
                    three scenes, under the image gate
  render_check      the main path (K2, compaction, K1) against the dense
                    plain path at 800x600, 4 spp, depth 50 on the bench
                    scene, under the image gate
  k6_check          K6 (pixel mask, BVH walk) against its plain version at
                    800x600 on ring-1000 and the mixed scene, and on both
                    without what covers the whole frame (their frames
                    must hold hits and misses): masks equal; here and in
                    k6s_check, dof and past_cap the pre-pass's mask table
                    must equal megakernel.mask_table_plain bit for bit,
                    and the walk reading it in place (the budget lowered)
                    must give the same mask
  k3_check          K3+K4 (bounce megakernel, bvh mode) against its plain
                    version on the lanes of a 64x48 frame, 4 spp, depth 50,
                    ring-1000 and the mixed scene: equal bit for bit; here
                    and in every phase below that runs K3+K4 (k3wide_check,
                    k1ext_check, bounds_check, kstate_check, fast_mc) the
                    main path's K3+K4 (the walk table in the shared memory
                    of persistent blocks) must equal the plain version bit
                    for bit, and the same launch reading its walk table in
                    place, radiance and work counters
  k3wide_check      K3-wide (the 4-wide stack walk of K3+K4 and K5) on the
                    lanes of a 64x48 frame, 4 spp, depth 12
                    (CHECK_DEPTH): K3+K4 on the
                    4-wide walk and on the binary walk (the same scene
                    without its 4-wide view), each against its plain
                    version (max lane error 0 or the image gate), on
                    ring-1000 and the mixed scene (where the two walks
                    must also pass the image gate against each other) and
                    on the twin scene, whose exact ties must split them
  k3walk_check      K3+K4's walk table: ico-2561 (two smooth icospheres
                    of 1,280 triangles over a plane, a 135 KB table) on
                    a strided subset of the lanes of a 64x48, 4 spp frame;
                    the mixed scene with the budget lowered
                    (megakernel.BVH_SMEM_BYTES) so the table is read in
                    place; 1,001 lanes (not a multiple of 32); a segment
                    resumed with every other lane dead: each equal to the
                    plain version bit for bit and to the launch reading the
                    table in place (work counters too)
  render_check_bvh  the main path (K6, compaction, K3+K4) against the
                    dense plain path at 160x120, 4 spp, depth 50 on
                    ring-1000, under the image gate
  k7_check          K7 (loop mode: brute force without a BVH, persistent
                    blocks, K1-guard in chunks of 96 occluders) on the
                    lanes of a 64x48 frame, 4 spp, depth 50, on the
                    icosphere golden scene without its BVH and on
                    ring-2500 without one (2,501 occluders, 51 KB of tables:
                    the launch opts in), both with their tables in shared
                    memory, and on ring-2500 with the budget lowered (read
                    through __ldg): launched once with its guard, equal to
                    itself unguarded and to the plain guarded version bit
                    for bit, timed guarded and unguarded against both
                    bounds; then on the twin scene's 96 spheres (exact
                    ties) K7 (the unroll limit lowered) equal to K1,
                    radiance and all eight work counters
  k1ext_check       the extended body (K1-ext) on the same lanes: K1 on
                    textured_mirror_demo and the extended_textured golden
                    scene, K3+K4 on smooth_shading_demo; image gate, with
                    the max lane error printed
  bounds_check      max_depth 100, 20 lights and 80 soft-shadow samples on
                    K1, K3+K4, K7 and K5 (grid-5833, where K5 must also
                    equal K3+K4 on the same tree, work counters too) (a
                    few hundred lanes each) against the plain version bit
                    for bit (K1 and K7 also against themselves unguarded)
  k6s_check         K6-stream (pixel mask, node-only walk, stream mode)
                    against its plain version at 800x600 on grid-5833 and
                    ico-10241 (pre-pass and walk), and on ring-1000 (and
                    without its ground)
                    forced into stream mode, where it must also pass every
                    pixel of K6's mask on the same tree: masks equal
  k5_check          K5 (bounce megakernel, stream mode) against its plain
                    version on a strided subset of the lanes of a 64x48
                    frame, 4 spp, depth 12, on grid-5833 and ico-10241
                    bit for bit, and bit-equal to K3+K4 on every lane of
                    the same frame of ring-1000 and the mixed scene forced
                    into stream mode (same tree); equal to K3+K4 on the
                    same tree, output and work counters, and to the plain
                    version on those subsets, on grid-5833 rebuilt with
                    leaves of 128 rows, on a lane count that is not a
                    multiple of 32 and on a segment resumed with every
                    other lane dead
  kstate_check      K1-state: K1, K3+K4, K5 and K7 each run bounces [0,4)
                    with state and then [4,12) from it, on a few thousand
                    lanes: alive flags and the state of alive lanes equal
                    to the plain version's, each segment's radiance
                    against the plain version's on the same inputs and the
                    sum against one [0,12) launch under the image gate
                    (max lane errors printed)
  render_check_stream  the stream main path (K6-stream, compaction, the
                    split ladder of K5 launches with K1-state) on
                    grid-5833 at 160x120, 4 spp, depth 12, against the
                    dense plain path and against the same path unsplit,
                    under the image gate; then one frame with the first
                    capacity forced below the survivors, which must report
                    overflow and equal the unsplit frame
  past_cap          a grid of 65^3 spheres over a plane (274,626
                    primitives, past the JAX package's 262,144 cap, where
                    its Renderer leaves its kernels for a banded jnp
                    engine) renders at 32x24, 1 spp, depth 2 through
                    K6-stream and K5, K5 equal to its plain version bit
                    for bit on a strided subset of the frame's lanes;
                    K6-stream reads its 393 KB mask table in place
                    (counted under pixel_mask_ldg) and equals its plain
                    version
  guard             K1-guard: K1 with its soft-shadow guard (the main
                    path's) against K1 without it and against the plain
                    guarded version (megakernel.shadow_factor_guarded in
                    the plain engine), on every lane of a 64x48, 4 spp
                    frame of the bench scene, textured_mirror_demo and
                    three golden scenes (spheres, boxes, a plane,
                    triangles), both entries: guarded = unguarded bit for
                    bit, and error 0 or the image gate against the plain
                    version; both entries' times and the share of (lane,
                    light, occluder) triples skipped
  dof               the masks' thin-lens branch: K2, K6 and K6-stream with
                    DoF (L=0.1, F=10 and L=0.25, F=5) equal to their plain
                    version (K2's on the kernel's own camera row, whose
                    DoF terms must equal _mask_camera's on the card) at
                    800x600 on the bench scene, ring-1000 (and
                    without its ground) and grid-5833, each a superset of
                    the pinhole mask; conservative against the dense plain
                    path (every pixel that some of 256 lens samples hits
                    lies in the mask, 160x120); the DoF main path against
                    the dense plain path under the image gate (depth 12)
  fast_mc           K1, K3+K4 and K7 with fast_mc (roulette from bounce 8,
                    the Renderer's, and from bounce 2; cutoff 1e-4) equal
                    to their plain version on the lanes of a 64x48 frame,
                    every segment of grid-5833's split ladder (K5) too,
                    with the lanes the roulette changed printed; the
                    fast_mc main path against the dense plain path
  bench             Renderer().render of the bench workload (800x600,
                    100 spp, depth 50, 16 soft-shadow rays, seed 0): one
                    warm-up, then 3 timed frames; launch counts are reset
                    just before the first timed frame and read just after;
                    in every bench frame the host must build no camera
                    row and no mask table (megakernel._mask_camera,
                    _bsphere_table and _mask_tree raise)
  bench_bvh         the same on ring-1000 through K6 and K3+K4 (one timed
                    frame instead of 3 when a frame takes over 30 s)
  bench_textured    the same on textured_mirror_demo (its look-at camera)
                    through K2 and K1-ext
  bench_smooth      the same on smooth_shading_demo (its look-at camera)
                    through K6 and K3+K4 with vertex normals
  bench_ico2561     the same on ico-2561 through K6 and K3+K4 (a 135 KB
                    walk table); every bvh frame must launch K3+K4 with its
                    walk table in shared memory
  bench_loop        the same on the icosphere golden scene without its BVH
                    (the go camera) through K2 and K7, with its tables in
                    shared memory and K1-guard
  bench_stream_grid the same (one timed frame) on grid-5833 through
                    K6-stream and the ladder of K5 launches (K1-state),
                    with the survivor fraction at each level of the ladder
  bench_stream_mesh the same on ico-10241 (its OBJ written at run time)
  bench_dof*        the bench scene, ring-1000 and grid-5833 (1 frame)
                    with the Renderer's depth of field (L=0.1, F=10)
  bench_fast_mc*    the bench scene and ring-1000 with the Renderer's
                    fast_mc; then the frame's own trace launches (K1,
                    K3+K4) against the plain version on a strided subset
                    of about 20k of their lanes, error 0, and against the
                    same launches without the roulette, which must change
                    some lanes
  effects           Renderer.render(scene, 800, 600, scene_config) on
                    atmosphere_demo.json (sky, fog, volumetric) and on
                    final_silver_prism_purple_cube.json with its fog,
                    bloom and vignette on and depthOfField, lensFlare and
                    chromaticAberration added, both with their look-at
                    camera at 100 spp, depth 50: stage times (render, each
                    effect, tone map); on atmosphere_demo the linear
                    image after the effects against the plain path's (the
                    wrappers' plain versions) under the image gate; on the
                    other, whose 48M lanes the plain path cannot trace
                    within the watchdog, the frame's own K1 launches
                    against the plain guarded version on a strided subset
                    of about 20k of their lanes (error 0 or the image
                    gate)
  adaptive          Renderer().render_adaptive (device accumulation) at
                    800x600, cap 100, depth 50, 16 soft-shadow rays,
                    min_spp 8, rel_tol 0.02 on the bench scene (K2 + K1),
                    ring-1000 (K6 + K3+K4) and grid-5833 (K6-stream + K5
                    through the full-capacity split ladder; were its deep
                    caps not "const", the ladder would run on the mixed
                    scene forced into stream mode): one warm-up, then 3
                    timed frames (1 on grid-5833), launch counts reset
                    just before the first and read just after; frame ms,
                    mean spp, samples taken/s; then one frame through the
                    stage hook (the same spp map): its stages, each ended
                    by a synchronise, the test rounds and the k read at
                    each, the reads of CUDA tensors to the host by round
                    (exactly one a test round, none on the others), every
                    ladder level within its capacity (overflow 0), and the
                    trace launches of the second batch (s0 8) against the
                    plain version at error 0: the radiance on a strided
                    subset of about 20k lanes (5k on ring-1000, whose
                    unconverged lanes are the costliest), each ladder
                    segment's radiance and state on about K5_SUBSET of its
                    lanes; then on the bench scene rel_tol = abs_tol = 0,
                    min_spp = max_spp = 8 against render_wavefront at 8 spp,
                    and device against host accumulation (spp maps equal
                    on >= 99.9% of pixels), both under the image gate
  aov_denoise       render_aovs and denoise (dense, a-trous over 3 passes,
                    each with and without the adaptive frame's variance
                    map) at 800x600 on the bench scene and ring-1000, each
                    against the same call with device="cpu" on the same
                    inputs (hit, mat_id, front_face equal; the float
                    buffers and the filtered image within 1e-5); ms of
                    each (median of 3); Renderer.render(denoise=True) once
  checkpoint        the bench scene at 160x120, cap 32, min_spp 4, in both
                    accumulation modes: render_adaptive interrupted (its
                    _save_ckpt raising after the second checkpoint) and
                    resumed equals the uninterrupted render bit for bit; a
                    changed split spec, batch or scene is refused;
                    render_with_checkpoints resumed equals one run
  diff              the differentiable path (raytrace_tpu_torch.diff, no
                    kernel: PyTorch autograd through the eager engine,
                    each bounce checkpointed) on the card against the
                    CPU: render_and_grad at 12x8, 2 spp, depth 3, 2 soft
                    rays on the simple and the cube scene of the JAX
                    package's gradient tests, the image within atol 1e-5
                    of the CPU's, every gradient leaf finite and within
                    rtol 1e-4, atol 1e-6 of the CPU's; the scan loop's
                    image equal to the while loop's (render_band) bit for
                    bit on the card
  diff_scale        gradients at scale (tools/measure_grad_scale.py, the
                    JAX package's four rows): 64x48, 2 spp, depth 3 on
                    grid-1001 (brute force, keep_accel) and ico-10241
                    (keep_accel, brute force): forward and
                    forward+backward ms (1 warm-up, median of 3; 1 timed
                    run past 5 s), the call's own peak device memory,
                    bounces run and rerun, every leaf finite, the
                    light-intensity gradient against a central
                    difference (eps 0.1, rtol 2e-2); grid-1001's
                    keep_accel image equal to brute force's bit for bit
                    and its material and light gradients within rtol
                    1e-3, atol 1e-6
  diff_inverse      inverse rendering (tools/inverse_rendering.py): the
                    light's intensity tripled and recovered within 10%
                    by 200 Adam steps at 16x16, 2 spp, depth 3; ms a step
                    and the loss at steps 0, 25 and 199
  kernels           K1 and K3+K4 against their plain versions on the bench
                    frames' own lanes (all of them for K1, a strided subset
                    of about 20k for K3+K4, whose main-path launches must
                    give the same lanes); K3+K4 at ring-1000, smooth and
                    ico-2561 with soft shadows, hard only and without
                    lights (the split of its walks), with its registers,
                    stack, spills and the walk table's shared memory;
                    each kernel's time per launch at
                    the main path's own shapes (CUDA events; the trace runs
                    in chunks of TRACE_LANES lanes, so ms x launches is a
                    frame's kernel time) beside its plain version's and
                    its bound for the same work; then K7 and K1-ext (and
                    K3+K4 with vertex normals) the same way at the three
                    new bench frames, on a strided subset of about 20k of
                    their lanes (2.5k on the smooth frame) for the plain
                    version, and K7 also unguarded (time and the bound of
                    the unguarded work); then K6-stream, K5
                    and K1-state at the grid-5833 frame: K5's time per
                    launch over the frame's own ladder segments (inputs
                    read through the stage hook; each segment equal to
                    K3+K4 on the same tree, work counters too, on a subset
                    of its lanes), the ladder's summed segment times
                    beside one unsplit launch per chunk over the same
                    lanes, and the plain version on a
                    strided subset of about K5_SUBSET lanes, and
                    K1-state's two segments against the plain version's
                    on a strided subset of about STATE_SUBSET of the
                    frame's lanes; K3-wide as K3+K4's and K5's unsplit
                    launches on the 4-wide walk beside the same launches
                    on the binary walk; K1-guard (K1 guarded and
                    unguarded at the bench frame's lanes, both bounds) and
                    the DoF masks at the DoF frames; K6 and K6-stream
                    (ring-1000, grid-5833, and their DoF frames) as the
                    mask launch (its table built in shared memory) and
                    the pre-pass kernel alone timed on the device (the
                    stream held by a sleep kernel while the host enqueues
                    200 launches, tools/measure_mask.py:device_ms, as K2
                    and K2-dof: one launch takes the host longer than
                    these kernels run), the bound over the mask's work
                    (the table built once, the walk), the table's bytes,
                    and the mask stage split into prep, launch and cumsum
                    (host clock, median of 20); K2 and K2-dof the same
                    way at the bench frames, K2 also at the textured and
                    loop frames and on ring-2500, its bound over the
                    design's own work (the rows built once, the center
                    ray and the planes a pixel, the leaf tests to each
                    pixel's first hit); the
                    pre-pass's own row (K6-table) at the past-cap frame,
                    whose table it writes; P1's three variants
                    (ms at the TPU tool's shape, launches from dma_probe,
                    P1's main path); registers, stack and spills of every
                    kernel from the build; each row the kernel walks on
                    the adaptive path also carries its launches in that
                    path's first timed frame (adaptive_launches)

The image gate is the goldens gate of tests/test_goldens.py: at most 0.1%
of pixels off by more than 1e-3 and a mean absolute error below 1e-4.

The bench scene is assets/sphere_reflections_light.json with the camera
mirrored to +Z (the shipped -Z position faces away from the geometry
under the reference camera). Ring-1000 is the reference benchmark's
1000-sphere ring (bench/suite.py:ring_scene_dict); the mixed scene adds a
prism, two cubes and a plane to a 90-sphere ring (124 primitives;
bench/suite.py:mixed_scene_dict). Every pixel of both passes the mask,
so k6_check adds both without their ground and back wall. The slice of
meshes, vertex normals, extended kinds and textures runs the three demo
scenes of assets/ that need it and two golden scenes of
tests/make_goldens.py (copied into bench/suite.py:golden_scene_dict,
since this script imports nothing of the JAX package). The stream tier
runs the JAX package's two stream workloads (tools/tpu_stream_smoke.py,
copied into bench/suite.py): grid-5833, an 18^3 grid of spheres, a third
of them glass, over a plane, and ico-10241, two smooth-shaded
4x-subdivided icospheres over a plane; small scenes are forced into
stream mode by lowering megakernel.MAX_BVH_KERNEL_PRIMS before they are
built. The last
two lines of output are the JSON kernel record and the contract line. Any
failure raises and exits non-zero with no contract line; without a GPU
the script exits non-zero at once.
"""

import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time

# A hang ends the run with a traceback and a non-zero exit.
faulthandler.dump_traceback_later(480, exit=True)

REPO = os.path.dirname(os.path.abspath(__file__))
W, H, SPP, DEPTH, SOFT = 800, 600, 100, 50, 16
SCENES = ("sphere_reflections_light", "two_red_cubes_scene",
          "final_silver_prism_purple_cube")
BVH_SCENES = ("ring1000", "mixed")
MASK_SCENES = BVH_SCENES + ("ring1000-noground", "mixed-noground")
LOOP_LDG_RING = 2500  # ring spheres: 51 KB of K7 tables, past 48 KB
PAST_CAP_SIDE = 65    # a grid of 65^3 spheres: past the 262,144 cap
PLAIN_CHUNK = 2048    # lanes per call of the plain brute-force engine
K3_SUBSET = 20000   # lanes of the bench frame checked against the plain
# The plain versions run on the host's clock, which varies by 1.5x between
# machines; these subsets keep the script well inside its watchdog.
K5_SUBSET = 2000    # lanes of a stream frame checked against the plain
PARTIAL_LANES = 500   # about this many for K5 on partial warps
SMOOTH_SUBSET = 2500  # the same for the smooth frame, whose plain version
                      # tests some 50 triangles a soft-shadow ray
STATE_SUBSET = 500    # lanes of a stream frame for K1-state's plain time
SLOW_FRAME_S = 30.0
# Depth of the checks whose point is not the depth (the 4-wide walk order,
# K5 against K3+K4 on one tree, K1-state's split, the stream and DoF main
# paths against the dense plain path): bounds_check holds every trace
# kernel at depth 100 and the kernels phase at the bench depth, so these
# run at depth 12 (the least at which the stream main path splits) to keep
# the script inside its watchdog.
CHECK_DEPTH = 12
# Lanes of an adaptive batch held against the plain version on ring-1000:
# a batch past the first holds only the unconverged pixels, the frame's
# costliest lanes (K3_SUBSET of them take the host some 50 s).
ADAPTIVE_RING_SUBSET = 5000
CARD = "card not read"  # nvidia-smi's name and power limit, read in env
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and fp32 instructions/s
# outside the tensor cores: the sheet's 67 TFLOP/s counts an FMA as two
# operations, and the kernels are built without FMA contraction, so each
# counted add, multiply, compare, divide or square root is one of 33.5e12
# per second. Used for the kernels' bounds only.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
# Operations of K6 and K6-stream, read off csrc/pixel_mask.cu (every add,
# multiply, compare, min/max, divide and square root counts one): the
# pre-pass a node row (with the DoF pad) and a leaf row of a triangle or
# of a sphere; the walk a slab test and a leaf test over a leaf row (with
# the thin-lens slack), and a pixel's center ray and a plane as K2's.
TABLE_NODE_OPS, TABLE_NODE_DOF_OPS = 47, 101
TABLE_TRI_OPS, TABLE_SPH_OPS = 50, 14
SLAB_OPS = 21
LEAF_OPS, LEAF_DOF_OPS = 13, 34
CENTER_RAY_OPS, PLANE_OPS = 27, 23
# The camera row (csrc/pixel_mask.cu:mask_camera, its look-at branch with
# depth of field, tanf counted as one), built once a block.
CAMERA_OPS = 110
# K1-guard's operations a guard evaluation, read off csrc/brute_force.cuh:
# a sphere's (sphere_oc 9, sphere_guard 31); a triangle's bounding sphere
# costs more and a plane's less: a round count, like the others.
GUARD_OPS = 40
# The scenes of K1-guard's check (bench/suite.py:golden_scene_dict copies
# the three goldens): spheres, boxes, a plane and triangles between them.
GUARD_SCENES = ("bench", "textured_mirror_demo", "cubes_dielectric_plane",
                "prism_perfectmirror", "spheres_metal_glass")
# Thin-lens settings of the DoF checks: the Go default, and a wide lens
# focused near (the case where the JAX kernel's leaf slack falls short).
DOF_LENSES = ((0.1, 10.0), (0.25, 5.0))
DOF_DENSE = 256       # lens samples a pixel of the conservativeness check


class Phase:
    """Print a line before and after a phase, with its seconds."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}: start", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        state = "done" if exc_type is None else "FAILED"
        print(f"== {self.name}: {state} in {dt:.1f} s", flush=True)
        return False


def image_gate(img, ref, what):
    """The goldens gate; raises when it fails."""
    import torch
    diff = (img - ref).abs().amax(dim=-1)
    frac = float((diff > 1e-3).float().mean())
    mean = float((img - ref).abs().mean())
    print(f"   {what}: pixels off >1e-3 {frac:.6f}, mean abs {mean:.3e}, "
          f"max {float(diff.max()):.3e}", flush=True)
    if not (frac <= 1e-3 and mean < 1e-4 and bool(torch.isfinite(img).all())):
        raise AssertionError(f"{what}: image gate failed")


def load_scene(name, device):
    from raytrace_tpu_torch import scene as scene_mod
    with open(os.path.join(REPO, "assets", f"{name}.json")) as f:
        data = json.load(f)
    # mirror the camera to +Z: the shipped -Z camera sees nothing
    data["camera"]["position"][2] = -data["camera"]["position"][2]
    return scene_mod.from_dict(data, device=device)[0]


def bvh_scene(name, device):
    """A bvh-mode scene of bench/suite.py:bvh_scene_dict by name."""
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.bench.suite import bvh_scene_dict
    return scene_mod.from_dict(bvh_scene_dict(name), device=device)[0]


def asset_scene(name, device):
    """An asset of the slice loaded from its file (mesh paths resolve
    against assets/); rendered with its own look-at camera."""
    from raytrace_tpu_torch import scene as scene_mod
    return scene_mod.load(os.path.join(REPO, "assets", f"{name}.json"),
                          device=device)[0]


def golden_scene(name, device, build_accel=None):
    """A golden scene of tests/make_goldens.py (bench/suite.py's copy)."""
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.bench.suite import golden_scene_dict
    return scene_mod.from_dict(golden_scene_dict(name)[0], device=device,
                               build_accel=build_accel)[0]


def with_lights(scene, n):
    """The scene with n point lights (run-time bound checks)."""
    import dataclasses
    import torch
    from raytrace_tpu_torch import scene as scene_mod
    dev = scene.device
    i = torch.arange(n, dtype=torch.float32, device=dev)
    pos = torch.stack([4.0 - 0.4 * i, torch.full_like(i, 6.0),
                       5.0 - 0.3 * i], 1)
    return dataclasses.replace(scene, lights=scene_mod.Lights(
        position=pos, color=torch.ones((n, 3), device=dev),
        intensity=torch.full((n,), 3.0, device=dev)))


def plain_trace(scene, o, d, pix, samp, cfg):
    """The plain version over lanes in chunks of PLAIN_CHUNK: lanes are
    independent, so the result is the one-call result, and the brute-force
    soft-shadow batches stay small on big tables."""
    import torch
    from raytrace_tpu_torch import trace as trace_mod
    return torch.cat([trace_mod.trace(scene, *(t[i:i + PLAIN_CHUNK]
                                               for t in (o, d, pix, samp)),
                                      cfg)
                      for i in range(0, o.shape[0], PLAIN_CHUNK)])


def cuda_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def lanes_of(scene, width, height, samples, cfg, chunks=False,
             go_camera=True):
    """The trace's input on the main path: the compacted pixels and the
    rays of their lanes, read from render_wavefront through its stage hook
    and joined over its trace chunks; with ``chunks``, also the lane count
    of each trace launch."""
    import torch
    from raytrace_tpu_torch import renderer as r
    seen = {"px": [], "origin": [], "direction": [], "pix": [], "samp": []}

    def hook(stage, **values):
        if stage == "lane_rays":
            for k in seen:
                seen[k].append(values[k])

    r.render_wavefront(scene, width=width, height=height, samples=samples,
                       cfg=cfg, go_camera=go_camera, hook=hook)
    out = tuple(torch.cat(seen[k]).contiguous() for k in seen)
    if chunks:
        return out + ([int(o.shape[0]) for o in seen["origin"]],)
    return out


def chunk_launches(mk, scene, lanes, sizes, cfg, counters=None, **kw):
    """Prepare the trace kernel on the main path's own chunks of the frame's
    lanes (``kw``: more arguments of prepare_trace): returns (out joined
    over the chunks, a function that launches every chunk once)."""
    import torch
    o, d, pix, samp = (t.split(sizes) for t in lanes)
    cnt = counters.split(sizes) if counters is not None else [None] * len(o)
    prepared = [mk.prepare_trace(scene, *c, cfg, counters=k, **kw)
                for c, k in zip(zip(o, d, pix, samp), cnt)]

    def launch_all():
        for _, launch in prepared:
            launch()

    return (lambda: torch.cat([out for out, _ in prepared])), launch_all


def pixel_image(px, rad, width, height, samples):
    import torch
    img = torch.zeros((width * height, 3), device=rad.device)
    img.index_add_(0, px, rad.reshape(-1, samples, 3).sum(dim=1))
    return (img / samples).reshape(height, width, 3)


def frame_stages(r, scene):
    """Milliseconds of each stage of one bench frame (render_wavefront,
    timed through its stage hook, then tonemap and the copy to the host;
    each stage is ended by a synchronise, so the sum exceeds a frame),
    the hit-pixel count, and for a split frame the ladder's levels:
    {bounce: [survivors, lanes, capacity]} summed over the chunks."""
    import torch
    from raytrace_tpu_torch import renderer as rmod
    from raytrace_tpu_torch.ops import tonemap
    ms = {}
    last = [time.perf_counter()]
    k = []
    levels = {}

    def mark(stage, **values):
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[stage] = ms.get(stage, 0.0) + (now - last[0]) * 1e3
        last[0] = now
        if stage == "count":
            k.append(values["k"])
        if stage == "overflow":
            levels["overflow"] = values["overflow"]
        if stage == "split_compact":
            lv = levels.setdefault(values["bounce"], [0, 0, 0])
            lv[0] += int(values["survivors"])
            lv[1] += values["lanes"]
            lv[2] += values["cap"]

    img = rmod.render_wavefront(scene, width=W, height=H, samples=SPP,
                                cfg=r.trace_config(), go_camera=r.go_camera,
                                hook=mark)
    tonemap.tonemap_rgb8(img).cpu()
    mark("tonemap_copy")
    return {s: round(v, 3) for s, v in ms.items()}, k[0], levels


def bench(scene, mk, what, slow_cut, go_camera=True, dof=False,
          fast_mc=False, frames=3):
    """Renderer().render at the bench settings (with the Renderer's depth
    of field or fast_mc when asked): one warm-up, then ``frames`` timed
    frames (1 when ``slow_cut`` and the warm-up took over SLOW_FRAME_S).
    Returns the launch counts of the first timed frame."""
    import torch
    from raytrace_tpu_torch import renderer as rmod
    r = rmod.Renderer(device=torch.device("cuda"))
    r.set_samples(SPP)
    r.set_max_depth(DEPTH)
    r.set_depth_of_field(dof)
    r.fast_mc = fast_mc
    r.go_camera = go_camera
    t0 = time.perf_counter()
    with no_host_mask_prep(mk):
        r.render(scene, W, H)  # warm-up
    warm = time.perf_counter() - t0
    n = 1 if slow_cut and warm > SLOW_FRAME_S else frames
    if n == 1:
        print(f"   the warm-up frame took {warm:.1f} s > {SLOW_FRAME_S} s: "
              "timing 1 frame, not 3", flush=True)
    times = []
    for i in range(n):
        if i == 0:
            mk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_host_mask_prep(mk):
            img = r.render(scene, W, H)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(mk.LAUNCHES)
    if img.shape != (H, W, 3) or str(img.dtype) != "uint8":
        raise AssertionError(f"bad image {img.shape} {img.dtype}")
    nonblack = float((img.sum(axis=2) > 0).mean())
    if nonblack <= 0.0:
        raise AssertionError(f"the {what} frame is black")
    with tempfile.TemporaryDirectory() as tmp:
        r.save_image(img, os.path.join(tmp, "bench.png"))
    best = sorted(times)[len(times) // 2]
    stages, k_px, levels = frame_stages(r, scene)
    print(f"   {what}: stages of one frame, ms (host clock, synchronised): "
          f"{stages}", flush=True)
    if levels:
        n0 = k_px * SPP
        ov = levels.pop("overflow", None)
        print(f"   {what}: split ladder (overflow {ov}), survivors at each "
              "level (bounce: survivors, of the frame's lanes, of the "
              "level's input lanes, capacity): " + "; ".join(
                  f"{b}: {v[0]}, {v[0] / n0:.4f}, {v[0] / v[1]:.4f}, {v[2]}"
                  for b, v in sorted(levels.items())), flush=True)
    print(f"   {what} [{CARD}]: frame seconds "
          f"{[round(t, 4) for t in times]}; median "
          f"{best:.4f} s = {W * H * SPP / best:.4e} camera samples/s; "
          f"hit pixels {k_px}, lanes {k_px * SPP}; non-black "
          f"{nonblack:.4f}; launches {launches}", flush=True)
    return launches


def mask_table_check(mk, scene, cfg, what, width=W, height=H):
    """K6 or K6-stream's pre-pass against mask_table_plain bit for bit, and
    the mask as the main path launches it (the walk building its table in
    shared memory, or reading the pre-pass's in place) against the same
    walk reading the table in place (megakernel.MASK_SMEM_BYTES lowered):
    masks equal, each launch counted. Returns (table bytes, in shared
    memory)."""
    import torch
    kw = dict(width=width, height=height, cfg=cfg)
    kernel = mk.MASKS[mk.require_mode(scene)]
    mk.reset_launches()
    out, launch = mk.prepare_pixel_mask(scene, **kw)
    launch()
    launch.prepass()
    want = mk.mask_table_plain(scene, launch.cam, cfg)
    if not torch.equal(launch.table.view(torch.int32),
                       want.view(torch.int32)):
        raise AssertionError(f"{what}: the pre-pass's table differs from "
                             "mask_table_plain")
    with lowered_budget(mk, "MASK_SMEM_BYTES"):
        ldg, ldg_launch = mk.prepare_pixel_mask(scene, **kw)
        ldg_launch()
    if ldg_launch.in_smem or not torch.equal(out, ldg):
        raise AssertionError(f"{what}: the walk reading its table in place "
                             "differs")
    in_place = int(not launch.in_smem)
    got = (mk.LAUNCHES["mask_table"], mk.LAUNCHES[kernel],
           mk.LAUNCHES["pixel_mask_ldg"])
    if got != (2 + in_place, 2, 1 + in_place):
        raise AssertionError(f"{what}: the mask launched {mk.LAUNCHES}")
    return 4 * launch.table.numel(), launch.in_smem


def table_work(mk, scene, cfg):
    """(operations, input bytes) of building a scene's mask table once:
    node rows and, in bvh mode, leaf rows; the tree's arrays, the camera
    row and, in bvh mode, prim_index and the sphere and triangle tables."""
    g, acc = scene.geometry, scene.accel
    ns = g.sph_center.shape[0]
    ops = acc.n_nodes * (TABLE_NODE_DOF_OPS if cfg.depth_of_field
                         else TABLE_NODE_OPS)
    n_bytes = 36 * acc.n_nodes + 4 * 18
    if mk.require_mode(scene) == "bvh":
        n_sph = int((acc.prim_index < ns).sum())
        ops += (n_sph * TABLE_SPH_OPS
                + (acc.prim_index.shape[0] - n_sph) * TABLE_TRI_OPS)
        n_bytes += (4 * acc.prim_index.shape[0] + 16 * ns
                    + 36 * g.tri_v0.shape[0])
    return ops, n_bytes


def mask_numbers(mk, scene, cfg, go_camera=True):
    """K6 or K6-stream at a bench frame's shape: ms of the mask launch as
    the main path runs it (the walk, which builds its table in shared
    memory, or the pre-pass and the walk in place) and of the pre-pass
    kernel alone, on the device (tools/measure_mask.py:device_ms), and of
    their plain versions; the bound of the mask's work (the table built
    once, the walk's tests), the table's bytes and whether it sits in
    shared memory, the work [slab tests, leaf tests], and the mask stage
    split on the host clock (tools/measure_mask.py:stage_ms, median of
    20)."""
    from raytrace_tpu_torch.tools.measure_mask import device_ms, stage_ms
    kw = dict(width=W, height=H, cfg=cfg, go_camera=go_camera)
    work = [0, 0]
    mk.pixel_mask_plain(scene, work=work, **kw)
    _, launch = mk.prepare_pixel_mask(scene, **kw)
    launch()
    ms = device_ms([launch])
    prepass_ms = device_ms([launch.prepass])
    plain = cuda_ms(lambda: mk.pixel_mask_plain(scene, **kw), 3)
    cam = launch.cam
    table_plain = cuda_ms(lambda: mk.mask_table_plain(scene, cam, cfg), 3)
    npl, n_px = scene.geometry.pl_point.shape[0], W * H
    table_ops, in_bytes = table_work(mk, scene, cfg)
    walk_ops = (n_px * (27 + 23 * npl) + work[0] * SLAB_OPS
                + work[1] * (LEAF_DOF_OPS if cfg.depth_of_field
                             else LEAF_OPS))
    bnd, by = bound(table_ops + walk_ops, in_bytes + 28 * npl + n_px)
    return dict(ms=ms, prepass_ms=prepass_ms, plain=plain,
                table_plain=table_plain, bound=bnd, by=by,
                table_bytes=4 * launch.table.numel(),
                table_in_smem=launch.in_smem, work=work,
                stage=stage_ms(mk, scene, cfg, go_camera, 20))


def mask_keys(m):
    """The extra keys of a K6 or K6-stream row."""
    return dict(prepass_ms=m["prepass_ms"], table_plain_ms=m["table_plain"],
                smem_bytes=m["table_bytes"] if m["table_in_smem"] else 0,
                table_bytes=m["table_bytes"], slab_tests=m["work"][0],
                leaf_tests=m["work"][1], mask_stage_ms=m["stage"])


def mask_line(name, m):
    """Print mask_numbers' reading."""
    st = m["stage"]
    where = ("built in shared memory" if m["table_in_smem"]
             else "read in place")
    print(f"   {name} [{CARD}]: work [slab tests, leaf tests] = {m['work']}; "
          f"{m['ms']:.4f} ms a mask (the pre-pass kernel alone "
          f"{m['prepass_ms']:.4f}) vs plain {m['plain']:.4f} ms (table "
          f"alone {m['table_plain']:.4f}); bound {m['bound']:.6f} ms "
          f"({m['by']}); table {m['table_bytes']} B "
          f"{where};"
          f" mask stage {st['stage']:.3f} ms: prep {st['prep']:.3f} (of it "
          f"a host camera row {st['camera']:.3f}), launch "
          f"{st['launch']:.3f}, cumsum {st['cumsum']:.3f}", flush=True)


def camera_row_check(mk, scene, cfg, what, go_camera=True, width=W,
                     height=H):
    """The camera row that every mask block builds (MaskLaunch.cam, one
    rt_mask_camera launch) against megakernel._mask_camera computed by
    PyTorch on the card: equal bit for bit. Prints the elements where the
    CPU's _mask_camera (the plain version's row in the CPU tests) differs,
    in ulps. Returns the card's row."""
    import types
    import torch
    kw = dict(width=width, height=height, cfg=cfg, go_camera=go_camera)
    _, launch = mk.prepare_pixel_mask(scene, **kw)
    row = launch.cam
    want = mk._mask_camera(scene, width, height, cfg, go_camera)
    if not torch.equal(row.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(
            f"{what}: the kernels' camera row differs from _mask_camera on "
            f"the card at {(row != want).nonzero()[:, 0].tolist()}: "
            f"{row.tolist()} vs {want.tolist()}")
    cpu = mk._mask_camera(types.SimpleNamespace(
        camera=scene.camera.to("cpu")), width, height, cfg, go_camera)
    ulps = (row.cpu().view(torch.int32).to(torch.int64)
            - cpu.view(torch.int32).to(torch.int64))
    diff = {int(i): int(ulps[i]) for i in ulps.nonzero()[:, 0]}
    print(f"   {what}: the kernels' camera row equals _mask_camera on the "
          f"card; against the CPU's row, ulps by element {diff}",
          flush=True)
    return row


def k2_mask_check(mk, scene, cfg, what, width=W, height=H, go_camera=True,
                  expect=None):
    """K2 as the main path launches it against its plain version on the
    kernel's own camera row (MaskLaunch.cam), the plain version going over
    the pixels in steps: masks equal; with ``expect`` the launch counts
    (nonzero keys) must be those. Returns the mask."""
    import torch
    kw = dict(width=width, height=height, cfg=cfg, go_camera=go_camera)
    mk.reset_launches()
    out, launch = mk.prepare_pixel_mask(scene, **kw)
    launch()
    launched = {k: v for k, v in mk.LAUNCHES.items() if v}
    want = mk.pixel_mask_plain(scene, cam=launch.cam, **kw)
    print(f"   {what} ({width}x{height}): {int(out.sum())} of "
          f"{width * height} pixels, {int((out != want).sum())} differ from "
          f"the plain version on the kernel's camera row; launched "
          f"{launched}", flush=True)
    if not torch.equal(out, want):
        raise AssertionError(f"{what}: K2 differs from its plain version")
    if expect is not None and launched != expect:
        raise AssertionError(f"{what}: K2 launched {launched}, not {expect}")
    return out


def k2_numbers(mk, scene, cfg, go_camera=True):
    """K2 at a bench frame's shape: ms a launch on the device
    (tools/measure_mask.py:device_ms) and its plain version's; the bound
    over the design's own work: the camera row and the leaf rows built
    once, the center ray and the planes a pixel, and the leaf tests that
    this frame's pixels run to their first hit (the plain early-exit form,
    megakernel.k2_walk_plain); inputs read once (the scene's camera,
    spheres, triangle vertices and planes), the mask written once; the
    rows, the leaf tests and the mask stage split (stage_ms)."""
    from raytrace_tpu_torch.tools.measure_mask import device_ms, stage_ms
    kw = dict(width=W, height=H, cfg=cfg, go_camera=go_camera)
    work = [0, 0]
    mk.pixel_mask_plain(scene, work=work, **kw)
    _, launch = mk.prepare_pixel_mask(scene, **kw)
    launch()
    ms = device_ms([launch])
    plain = cuda_ms(lambda: mk.pixel_mask_plain(scene, **kw), 3)
    g = scene.geometry
    ns, nt, npl = (g.sph_center.shape[0], g.tri_v0.shape[0],
                   g.pl_point.shape[0])
    n_px = W * H
    ops = (CAMERA_OPS + ns * TABLE_SPH_OPS + nt * TABLE_TRI_OPS
           + n_px * (CENTER_RAY_OPS + PLANE_OPS * npl)
           + work[1] * (LEAF_DOF_OPS if cfg.depth_of_field else LEAF_OPS))
    in_bytes = 4 * (3 + 3 + 3 + 1 + 1) + 16 * ns + 36 * nt + 24 * npl
    bnd, by = bound(ops, in_bytes + n_px)
    return dict(ms=ms, plain=plain, bound=bnd, by=by, rows=ns + nt,
                leaf_tests=work[1], rows_in_smem=launch.in_smem,
                stage=stage_ms(mk, scene, cfg, go_camera, 20))


def k2_line(name, m):
    """Print k2_numbers' reading."""
    st = m["stage"]
    print(f"   {name} [{CARD}]: {m['rows']} rows, {m['leaf_tests']} leaf "
          f"tests; {m['ms']:.4f} ms a mask vs plain {m['plain']:.4f} ms; "
          f"bound {m['bound']:.6f} ms ({m['by']}); mask stage "
          f"{st['stage']:.3f} ms: prep {st['prep']:.3f}, launch "
          f"{st['launch']:.3f}, cumsum {st['cumsum']:.3f}", flush=True)


def k2_keys(m):
    """The extra keys of a K2 row."""
    return dict(rows=m["rows"], leaf_tests=m["leaf_tests"],
                smem_bytes=4 * (8 * m["rows"] + 20) if m["rows_in_smem"]
                else None, mask_stage_ms=m["stage"])


class no_host_mask_prep:
    """Within the block, a mask launch that builds its camera row,
    bounding spheres, tree or plane table on the host raises
    (megakernel._mask_camera, _bsphere_table and _mask_tree replaced)."""
    NAMES = ("_mask_camera", "_bsphere_table", "_mask_tree")

    def __init__(self, mk):
        self.mk = mk

    def __enter__(self):
        self.old = {n: getattr(self.mk, n) for n in self.NAMES}

        def boom(*a, **k):
            raise AssertionError("the host built a camera row or a mask "
                                 "table on the card path")

        for n in self.NAMES:
            setattr(self.mk, n, boom)

    def __exit__(self, *exc):
        for n, f in self.old.items():
            setattr(self.mk, n, f)
        return False


def k1_ops(scene, cnt):
    """Operations K1 ran, from its per-lane work counters and the
    per-test costs read off csrc/: every add, multiply, divide, square
    root, compare and min/max counts one. Shading arithmetic is left out,
    so the count, and the bound from it, is low. K1-guard's work: GUARD_OPS
    a guard evaluation, and only the soft-shadow rays it drew (the soft
    counter less the rays it left undrawn) and the tests it ran."""
    import torch
    g = scene.geometry
    ns, nt = g.sph_center.shape[0], g.n_hit_tris
    npl, nb = g.pl_point.shape[0], g.box_min.shape[0]
    c = [int(x) for x in cnt.to(torch.int64).sum(0)]
    closest, hard, soft, cheap, costly, guards, _, undrawn = c
    drawn = soft - undrawn
    inv = 6 if nb else 0
    per_closest = 6 + inv + 25 * ns + 54 * nt + 17 * npl + 27 * nb
    cheap_cost = 17 if npl else 25      # plane 17, sphere 25
    costly_cost = 27 if nb else 65      # box 27, division-free triangle 65
    return (closest * per_closest + (hard + drawn) * (6 + inv) + drawn * 104
            + cheap * cheap_cost + costly * costly_cost
            + guards * GUARD_OPS), c


def k3_ops(cnt):
    """Operations of K3+K4 and of K4 alone, from the per-lane work
    counters (megakernel.prepare_trace_bvh) and per-test costs read off
    csrc/ as for K1: slab test 21, sphere 25, triangle 54, plane 17 (the
    cheaper of plane and box), per ray 12 (direction terms); fused walk:
    slab 46 (with the cone growth), (ray, sphere) 17, (ray, triangle) 25,
    and 104 per soft ray for its direction (ball, normalise)."""
    import torch
    c = [int(x) for x in cnt.to(torch.int64).sum(0)]
    closest, hard, soft, nodes, sph, tri, fnodes, fsph, ftri, brute = c
    k4 = soft * 104 + fnodes * 46 + fsph * 17 + ftri * 25
    total = ((closest + hard) * 12 + nodes * 21 + sph * 25 + tri * 54
             + brute * 17 + k4)
    return total, k4, c


def bound(ops, n_bytes):
    t_ops, t_bytes = ops / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from raytrace_tpu_torch import renderer as rmod
        from raytrace_tpu_torch import trace as trace_mod
        from raytrace_tpu_torch.ops import _build
        from raytrace_tpu_torch.ops import megakernel as mk
    except ImportError as e:
        print(f"chip_smoke: the raytrace_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    record = {}

    with Phase("env"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        gpu_line = smi[0].strip() if smi else "nvidia-smi: no output"
        global CARD
        CARD = gpu_line
        print(gpu_line, flush=True)
        print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} device(s)", flush=True)

    with Phase("build"):
        res = _build.build()
        print(f"   nvcc {'built' if res.built else 'cached'} in "
              f"{res.seconds:.1f} s -> {os.path.relpath(res.path, REPO)}",
              flush=True)
        for ln in res.ptxas:
            if ("Used" in ln or "spill" in ln or "Compiling" in ln):
                print(f"   {ln}", flush=True)
        _build.library()

    with Phase("dma_probe"):
        # P1 through its tool's own measurement (its main path): every
        # variant at every shape equal to the plain chain bit for bit
        from raytrace_tpu_torch.tools import measure_dma_stream as p1
        p1.reset_launches()
        probe = p1.measure()
        p1_launches = dict(p1.LAUNCHES)
        for r in probe:
            print(f"   {r['shape']} ({r['rows']} x {r['row_bytes']} B, L2 "
                  f"{r['l2']}) {r['variant']}: equal {r['ok']}, "
                  f"{r['ms']:.4f} ms, {r['ns_per_step']:.1f} ns a step; "
                  f"plain {r['plain_ms']:.1f} ms", flush=True)
            if not r["ok"]:
                raise AssertionError(f"P1 {r['variant']} differs from its "
                                     f"plain version at {r['shape']}")
        if any(v < 1 for v in p1_launches.values()):
            raise AssertionError(f"P1 did not launch every variant: "
                                 f"{p1_launches}")

    cfg = trace_mod.TraceConfig(max_depth=DEPTH, shadow_samples=SOFT, seed=0)
    ccfg = trace_mod.TraceConfig(max_depth=CHECK_DEPTH, shadow_samples=SOFT,
                                 seed=0)
    scenes = {n: load_scene(n, dev) for n in SCENES}
    bvh_scenes = {n: bvh_scene(n, dev) for n in MASK_SCENES}
    for n, s in bvh_scenes.items():
        if mk._kernel_mode(s) != "bvh":
            raise AssertionError(f"{n} is not a bvh-mode scene")

    with Phase("k2_check"):
        for name, s in scenes.items():
            got = k2_mask_check(mk, s, cfg, f"K2 {name}",
                                expect={"pixel_mask": 1})
            camera_row_check(mk, s, cfg, f"{name}, go camera")
            want = mk.pixel_mask_plain(s, width=W, height=H, cfg=cfg)
            missing = int((want & ~got).sum())
            extra = int((got & ~want).sum())
            print(f"   {name}: {int(got.sum())} of {W * H} pixels, "
                  f"{missing + extra} differ ({missing} missing, {extra} "
                  "extra)", flush=True)
            if not torch.equal(got, want):
                raise AssertionError(f"K2 differs from its plain version "
                                     f"on {name}")
            if name == SCENES[0]:
                record["k2_err"] = float(
                    (got.float() - want.float()).abs().max())
        from raytrace_tpu_torch import scene as scene_mod
        from raytrace_tpu_torch.bench.suite import bvh_scene_dict
        textured = asset_scene("textured_mirror_demo", dev)
        for lens in (None,) + DOF_LENSES:
            c = cfg if lens is None else dof_cfg(trace_mod, lens)
            camera_row_check(mk, textured, c, f"textured_mirror_demo, "
                             f"look-at camera, lens {lens}", go_camera=False)
            camera_row_check(mk, scenes[SCENES[0]], c, f"bench, go camera, "
                             f"lens {lens}")
        k2_mask_check(mk, textured, cfg, "K2 textured_mirror_demo (look-at "
                      "camera)", go_camera=False)
        # past the shared-memory budget (lowered to 0: a row a chunk)
        k2_loop = {
            "icosphere": golden_scene("mesh_smooth_icosphere", dev,
                                      build_accel=False),
            f"ring{LOOP_LDG_RING}": loop_ring_scene(LOOP_LDG_RING, dev),
            f"ring{LOOP_LDG_RING}-noground": scene_mod.from_dict(
                bvh_scene_dict(f"ring{LOOP_LDG_RING}-noground"), device=dev,
                build_accel=False)[0]}
        past = {"pixel_mask": 1, "pixel_mask_chunked": 1}
        for name, s in (("bench", scenes[SCENES[0]]),
                        ("icosphere", k2_loop["icosphere"])):
            with lowered_budget(mk, "MASK_SMEM_BYTES"):
                k2_mask_check(mk, s, cfg, f"K2 {name} past its budget",
                              160, 120, expect=past)
        # loop mode at full size: every pixel hits the ground's bound at
        # the first row, and without the ground each tests up to 2,500
        for name, s in k2_loop.items():
            if mk._kernel_mode(s) != "loop":
                raise AssertionError(f"{name} is not a loop-mode scene")
            got = k2_mask_check(mk, s, cfg, f"K2 {name}",
                                expect={"pixel_mask": 1})
            if name.endswith("noground") and not (got.any()
                                                  and (~got).any()):
                raise AssertionError(f"{name}: the frame must hold both "
                                     "hits and misses")
        record["k2_ring"] = k2_loop[f"ring{LOOP_LDG_RING}"]

    with Phase("k1_check"):
        for name, s in scenes.items():
            px, o, d, pix, samp = lanes_of(s, 64, 48, 4, cfg)
            got = mk.trace(s, o, d, pix, samp, cfg)
            want = trace_mod.trace(s, o, d, pix, samp, cfg)
            err = float((got - want).abs().max())
            print(f"   {name}: {o.shape[0]} lanes, max lane error "
                  f"{err:.3e}", flush=True)
            image_gate(pixel_image(px, got, 64, 48, 4),
                       pixel_image(px, want, 64, 48, 4), f"K1 {name}")

    with Phase("render_check"):
        rcfg = trace_mod.TraceConfig(max_depth=DEPTH, shadow_samples=SOFT)
        main_img = rmod.render_wavefront(scenes[SCENES[0]], width=W,
                                         height=H, samples=4, cfg=rcfg)
        ref_img = rmod.render_band(scenes[SCENES[0]], 0, width=W, height=H,
                                   band_h=H, samples=4, cfg=rcfg)
        image_gate(main_img, ref_img, "main path vs dense plain path")

    with Phase("k6_check"):
        for name, s in bvh_scenes.items():
            got = mk.pixel_mask(s, width=W, height=H, cfg=cfg)
            want = mk.pixel_mask_plain(s, width=W, height=H, cfg=cfg)
            missing = int((want & ~got).sum())
            extra = int((got & ~want).sum())
            print(f"   {name}: {s.accel.n_nodes} nodes, {int(got.sum())} of "
                  f"{W * H} pixels, {missing + extra} differ ({missing} "
                  f"missing, {extra} extra)", flush=True)
            if name.endswith("-noground") and not (want.any()
                                                   and (~want).any()):
                raise AssertionError(f"{name}: the frame must hold both "
                                     "hits and misses")
            if not torch.equal(got, want):
                raise AssertionError(f"K6 differs from its plain version "
                                     f"on {name}")
            nbytes, in_smem = mask_table_check(mk, s, cfg, f"K6 {name}")
            print(f"   {name}: the pre-pass's table ({nbytes} B, in shared "
                  f"memory {in_smem}) equals mask_table_plain; the walk "
                  "reading it in place gives the same mask", flush=True)
            if name == BVH_SCENES[0]:
                record["k6_err"] = float(
                    (got.float() - want.float()).abs().max())

    with Phase("k3_check"):
        for name in BVH_SCENES:
            s = bvh_scenes[name]
            px, o, d, pix, samp = lanes_of(s, 64, 48, 4, cfg)
            got = mk.trace(s, o, d, pix, samp, cfg)
            want = trace_mod.trace(s, o, d, pix, samp, cfg)
            if not torch.equal(got, k3_both(mk, s, (o, d, pix, samp), cfg,
                                            want)):
                raise AssertionError(f"{name}: the main path's K3+K4 launch "
                                     "differs from k3_both's")
            err = float((got - want).abs().max())
            print(f"   {name}: {o.shape[0]} lanes, equal to the same launch "
                  f"reading its walk table in place; max lane error {err:.3e}",
                  flush=True)

    with Phase("k3wide_check"):
        twins = twin_scene(dev)
        for name, s in (("ring1000", bvh_scenes["ring1000"]),
                        ("mixed", bvh_scenes["mixed"]), ("twins", twins)):
            err, differ = wide_check(mk, trace_mod, s, ccfg, name)
            record.setdefault("k3wide_err", []).append(err)
            if name == "twins" and differ < 5:
                raise AssertionError("the twin scene's ties must split the "
                                     "4-wide and the binary walk")

    with Phase("render_check_bvh"):
        ring = bvh_scenes[BVH_SCENES[0]]
        rcfg = trace_mod.TraceConfig(max_depth=DEPTH, shadow_samples=SOFT)
        main_img = rmod.render_wavefront(ring, width=160, height=120,
                                         samples=4, cfg=rcfg)
        ref_img = rmod.render_band(ring, 0, width=160, height=120,
                                   band_h=120, samples=4, cfg=rcfg)
        image_gate(main_img, ref_img, "bvh main path vs dense plain path")

    with Phase("k7_check"):
        loop_scenes = {
            "icosphere": golden_scene("mesh_smooth_icosphere", dev,
                                      build_accel=False),
            f"ring{LOOP_LDG_RING}": loop_ring_scene(LOOP_LDG_RING, dev)}
        cases = [(name, s, False) for name, s in loop_scenes.items()]
        cases.append((f"ring{LOOP_LDG_RING}, tables read in place",
                      loop_scenes[f"ring{LOOP_LDG_RING}"], True))
        for name, s, in_place in cases:
            if mk._kernel_mode(s) != "loop":
                raise AssertionError(f"{name} is not a loop-mode scene")
            with (lowered_budget(mk, "LOOP_SMEM_BYTES") if in_place
                  else contextlib.nullcontext()):
                k7_check(mk, s, name, in_place, cfg, record)
        k7_equals_k1(mk, twin_spheres(dev), cfg)

    with Phase("k1ext_check"):
        ext = (("textured_mirror_demo", asset_scene("textured_mirror_demo",
                                                    dev), False,
                "trace_unroll"),
               ("extended_textured", golden_scene("extended_textured", dev),
                True, "trace_unroll"),
               ("smooth_shading_demo", asset_scene("smooth_shading_demo",
                                                   dev), False, "trace_bvh"))
        for name, s, go, kernel in ext:
            px, o, d, pix, samp = lanes_of(s, 64, 48, 4, cfg, go_camera=go)
            mk.reset_launches()
            got = mk.trace(s, o, d, pix, samp, cfg)
            if mk.LAUNCHES[kernel] != 1:
                raise AssertionError(f"{name}: {kernel} was not launched")
            want = trace_mod.trace(s, o, d, pix, samp, cfg)
            if kernel == "trace_bvh" and not torch.equal(
                    got, k3_both(mk, s, (o, d, pix, samp), cfg, want)):
                raise AssertionError(f"{name}: the main path's K3+K4 launch "
                                     "differs from k3_both's")
            err = float((got - want).abs().max())
            print(f"   {name} ({kernel}): {o.shape[0]} lanes, max lane "
                  f"error {err:.3e}", flush=True)
            image_gate(pixel_image(px, got, 64, 48, 4),
                       pixel_image(px, want, 64, 48, 4), f"K1-ext {name}")
            record.setdefault("k1ext_check_err", []).append(err)

    obj_dir = tempfile.TemporaryDirectory()
    stream_scenes = {"grid5833": stream_scene("grid", dev),
                     "ico10241": stream_scene("mesh", dev, obj_dir.name)}
    ico2561 = ico2561_scene(dev, obj_dir.name)

    with Phase("k3walk_check"):
        k3walk_check(mk, trace_mod, {"ico2561": ico2561,
                                     "mixed": bvh_scenes["mixed"]}, cfg,
                     record)

    with Phase("bounds_check"):
        bcfg = trace_mod.TraceConfig(max_depth=100, shadow_samples=80,
                                     seed=0)
        for name, s in (("unroll", scenes[SCENES[2]]),
                        ("bvh", bvh_scenes["mixed"]),
                        ("loop", loop_scenes["icosphere"]),
                        ("stream", stream_scenes["grid5833"])):
            s = with_lights(s, 20)
            # the stream scene's plain version is slow at these bounds
            w, h = (6, 5) if name == "stream" else (12, 9)
            px, o, d, pix, samp = lanes_of(s, w, h, 2, bcfg)
            lanes = (o, d, pix, samp)
            want = trace_mod.trace(s, *lanes, bcfg)
            if name == "stream":
                got = k5_both(mk, s, lanes, bcfg, want)
            elif name == "bvh":
                got = k3_both(mk, s, lanes, bcfg, want)
            else:
                got = brute_both(mk, s, lanes, bcfg, want)[0]
            err = float((got - want).abs().max())
            print(f"   {name}: depth 100, 20 lights, 80 soft rays, "
                  f"{o.shape[0]} lanes, max lane error {err:.3e}", flush=True)

    with Phase("k6s_check"):
        for name, s in stream_scenes.items():
            if mk._kernel_mode(s) != "stream":
                raise AssertionError(f"{name} is not a stream-mode scene")
            got = mk.pixel_mask(s, width=W, height=H, cfg=cfg)
            want = mk.pixel_mask_plain(s, width=W, height=H, cfg=cfg)
            print(f"   {name}: {s.prim_count} primitives, leaf "
                  f"{s.accel.leaf_size}, {s.accel.n_nodes} nodes, "
                  f"{int(got.sum())} of {W * H} pixels, "
                  f"{int((got != want).sum())} differ", flush=True)
            if not torch.equal(got, want):
                raise AssertionError(f"K6-stream differs from its plain "
                                     f"version on {name}")
            nbytes, in_smem = mask_table_check(mk, s, cfg,
                                               f"K6-stream {name}")
            print(f"   {name}: the pre-pass's table ({nbytes} B, in shared "
                  f"memory {in_smem}) equals mask_table_plain; the walk "
                  "reading it in place gives the same mask", flush=True)
        record["k6s_err"] = 0.0
        for name in ("ring1000", "ring1000-noground"):
            with forced_stream(mk):
                s = bvh_scene(name, dev)
                got = mk.pixel_mask(s, width=W, height=H, cfg=cfg)
                want = mk.pixel_mask_plain(s, width=W, height=H, cfg=cfg)
                mask_table_check(mk, s, cfg, f"K6-stream {name}")
            k6 = mk.pixel_mask(s, width=W, height=H, cfg=cfg)  # same tree
            print(f"   {name} forced into stream mode: {int(got.sum())} of "
                  f"{W * H} pixels, K6 on the same tree {int(k6.sum())}, "
                  f"{int((got != want).sum())} differ from the plain "
                  "version", flush=True)
            if not torch.equal(got, want):
                raise AssertionError(f"K6-stream differs from its plain "
                                     f"version on {name}")
            if (k6 & ~got).any():
                raise AssertionError(f"K6-stream drops pixels of K6 on "
                                     f"{name}")

    with Phase("k5_check"):
        for name, s in stream_scenes.items():
            px, o, d, pix, samp = lanes_of(s, 64, 48, 4, ccfg)
            idx = torch.arange(0, o.shape[0], max(1, o.shape[0] // K5_SUBSET),
                               device=dev)
            sub = tuple(t[idx] for t in (o, d, pix, samp))
            mk.reset_launches()
            got = mk.trace(s, *sub, ccfg)
            if mk.LAUNCHES["trace_stream"] != 1:
                raise AssertionError(f"K5 was not launched: {mk.LAUNCHES}")
            want = plain_trace(s, *sub, ccfg)
            if not torch.equal(got, k5_both(mk, s, sub, ccfg, want)):
                raise AssertionError(f"K5 is not deterministic on {name}")
            err = float((got - want).abs().max())
            print(f"   {name}: {idx.numel()} of {o.shape[0]} lanes, equal to "
                  f"K3+K4 on the same tree (work counters too), max lane "
                  f"error {err:.3e}", flush=True)
            record.setdefault("k5_check_err", []).append(err)
        for name in BVH_SCENES:
            with forced_stream(mk):
                s = bvh_scene(name, dev)
                px, o, d, pix, samp = lanes_of(s, 64, 48, 4, ccfg)
                mk.reset_launches()
                k5 = mk.trace(s, o, d, pix, samp, ccfg)
                if mk.LAUNCHES["trace_stream"] != 1:
                    raise AssertionError(f"K5 was not launched on {name}")
            k3 = mk.trace(s, o, d, pix, samp, ccfg)  # bvh mode, same tree
            print(f"   {name} forced into stream mode: {o.shape[0]} lanes, "
                  f"K5 vs K3+K4 max lane error "
                  f"{float((k5 - k3).abs().max()):.3e}", flush=True)
            if not torch.equal(k5, k3):
                raise AssertionError(f"K5 differs from K3+K4 on {name}")
        # the group walk on leaves of 128 rows (a group loops over more
        # rows than it has threads), then on partial warps: a lane count
        # that is not a multiple of 32, and a segment resumed with every
        # other lane dead
        from raytrace_tpu_torch import scene as scene_mod
        g128 = scene_mod.with_accel(stream_scenes["grid5833"], leaf_size=128)
        px, o, d, pix, samp = lanes_of(g128, 64, 48, 4, ccfg)
        idx = torch.arange(0, o.shape[0], max(1, o.shape[0] // K5_SUBSET),
                           device=dev)
        cases = [("grid5833, leaves of 128 rows", g128,
                  tuple(t[idx] for t in (o, d, pix, samp)), {})]
        n_part = 32 * (PARTIAL_LANES // 32) + 19
        part = tuple(t[idx[:n_part]] for t in (o, d, pix, samp))
        grid = stream_scenes["grid5833"]
        cases.append((f"grid5833, {n_part} lanes", grid, part, {}))
        _, st = mk.trace(grid, *part, ccfg, end_bounce=2, return_state=True)
        alive = st["alive"].clone()
        alive[::2] = 0.0
        kw = dict(start_bounce=2, init_throughput=st["throughput"],
                  init_alive=alive)
        cases.append((f"grid5833, {n_part} lanes from bounce 2, every other "
                      "lane dead", grid,
                      (st["origin"], st["direction"]) + part[2:], kw))
        for name, s, lanes, kw in cases:
            want = trace_mod.trace(s, *lanes, ccfg, **kw)
            got = k5_both(mk, s, lanes, ccfg, want, **kw)
            err = float((got - want).abs().max())
            print(f"   {name}: {lanes[0].shape[0]} lanes, equal to K3+K4 on "
                  f"the same tree (work counters too); max lane error vs "
                  f"plain {err:.3e}", flush=True)
            if kw and got[::2].any():
                raise AssertionError("K5 gave radiance to dead lanes")
            record["k5_check_err"].append(err)

    with Phase("kstate_check"):
        for name, s, kernel in (
                ("K1", scenes[SCENES[2]], "trace_unroll"),
                ("K3+K4", bvh_scenes["mixed"], "trace_bvh"),
                ("K5", stream_scenes["grid5833"], "trace_stream"),
                ("K7", loop_scenes["icosphere"], "trace_loop")):
            err = state_check(mk, trace_mod, s, kernel, ccfg, name)
            record.setdefault("kstate_err", []).append(err)
        px, o, d, pix, samp = lanes_of(bvh_scenes["mixed"], 64, 48, 4, ccfg)
        _, st = k3_both(mk, bvh_scenes["mixed"], (o, d, pix, samp), ccfg,
                        end_bounce=4, return_state=True)
        k3_both(mk, bvh_scenes["mixed"], (st["origin"], st["direction"],
                                          pix, samp), ccfg, start_bounce=4,
                init_throughput=st["throughput"], init_alive=st["alive"])
        print(f"   K3+K4's state entry: [0,4) with state and "
              f"[4,{CHECK_DEPTH}) from it equal to the plain version and to "
              "the same launches reading the walk table in place (work "
              "counters too)", flush=True)

    with Phase("render_check_stream"):
        render_check_stream(mk, rmod, trace_mod, stream_scenes["grid5833"])

    with Phase("past_cap"):
        past_cap_check(mk, rmod, trace_mod, dev, record)

    with Phase("guard"):
        for name in GUARD_SCENES:
            s, go = guard_scene(name, dev)
            if mk._kernel_mode(s) != "unroll":
                raise AssertionError(f"{name} is not an unroll-mode scene")
            err, _, _ = guard_check(mk, trace_mod, s, cfg, name, go)
            record.setdefault("guard_err", []).append(err)

    grid = stream_scenes["grid5833"]
    with Phase("dof"):
        for name, s, kernel in (
                ("bench", scenes[SCENES[0]], "pixel_mask"),
                ("ring1000", bvh_scenes["ring1000"], "pixel_mask_bvh"),
                ("ring1000-noground", bvh_scenes["ring1000-noground"],
                 "pixel_mask_bvh"),
                ("grid5833", grid, "pixel_mask_stream")):
            pin = mk.pixel_mask(s, width=W, height=H, cfg=cfg)
            for lens in DOF_LENSES:
                dcfg = dof_cfg(trace_mod, lens, max_depth=DEPTH,
                               shadow_samples=SOFT)
                mk.reset_launches()
                got = mk.pixel_mask(s, width=W, height=H, cfg=dcfg)
                if (mk.LAUNCHES[kernel], mk.LAUNCHES["mask_dof"]) != (1, 1):
                    raise AssertionError(f"{name}: the DoF mask launched "
                                         f"{mk.LAUNCHES}")
                cam = None
                if kernel == "pixel_mask":   # K2 on its own camera row
                    cam = camera_row_check(mk, s, dcfg, f"{name} L={lens[0]},"
                                           f" F={lens[1]}")
                want = mk.pixel_mask_plain(s, width=W, height=H, cfg=dcfg,
                                           cam=cam)
                print(f"   {name} ({kernel}) L={lens[0]}, F={lens[1]}: "
                      f"{int(got.sum())} of {W * H} pixels (pinhole "
                      f"{int(pin.sum())}), {int((got != want).sum())} "
                      "differ from the plain version", flush=True)
                if not torch.equal(got, want):
                    raise AssertionError(f"{kernel} with DoF differs from "
                                         f"its plain version on {name}")
                if kernel != "pixel_mask":
                    mask_table_check(mk, s, dcfg, f"{kernel} with DoF on "
                                     f"{name}")
                if (pin & ~got).any():
                    raise AssertionError(f"{name}: the DoF mask drops "
                                         "pinhole pixels")
        record["dof_mask_err"] = 0.0
        for name, s in (("bench", scenes[SCENES[0]]),
                        ("ring1000-noground", bvh_scenes["ring1000-noground"]),
                        ("grid5833", grid)):
            for lens in DOF_LENSES:
                dof_dense_check(mk, rmod, s, dof_cfg(trace_mod, lens), name)
        dcfg = dof_cfg(trace_mod, DOF_LENSES[1], max_depth=CHECK_DEPTH,
                       shadow_samples=SOFT)
        for name, s, w, h in (("bench", scenes[SCENES[0]], 160, 120),
                              ("ring1000", bvh_scenes["ring1000"], 160, 120),
                              ("grid5833", grid, 80, 60)):
            mk.reset_launches()
            img = rmod.render_wavefront(s, width=w, height=h, samples=4,
                                        cfg=dcfg)
            if mk.LAUNCHES["mask_dof"] != 1:
                raise AssertionError(f"{name}: the DoF main path launched "
                                     f"{mk.LAUNCHES}")
            ref = rmod.render_band(s, 0, width=w, height=h, band_h=h,
                                   samples=4, cfg=dcfg)
            image_gate(img, ref, f"DoF main path on {name} ({w}x{h}, 4 spp) "
                       "vs dense plain path")

    with Phase("fast_mc"):
        # the Renderer's settings (roulette from bounce 8), and roulette
        # from bounce 2, where it ends most lanes that scatter
        fcfgs = [trace_mod.TraceConfig(max_depth=DEPTH, shadow_samples=SOFT,
                                       russian_roulette_start=rr,
                                       throughput_epsilon=1e-4)
                 for rr in (8, 2)]
        fcfg = fcfgs[0]
        rf = rmod.Renderer(device=dev)
        rf.set_max_depth(DEPTH)
        rf.fast_mc = True
        if rf.trace_config() != fcfg:
            raise AssertionError("the Renderer's fast_mc settings moved: "
                                 f"{rf.trace_config()}")
        for name, s, kernel in (
                ("bench", scenes[SCENES[0]], "trace_unroll"),
                ("spheres_metal_glass", golden_scene("spheres_metal_glass",
                                                     dev), "trace_unroll"),
                ("ring1000", bvh_scenes["ring1000"], "trace_bvh"),
                ("icosphere", loop_scenes["icosphere"], "trace_loop")):
            px, o, d, pix, samp = lanes_of(s, 64, 48, 4, cfg)
            full = mk.trace(s, o, d, pix, samp, cfg)
            cut = mk.trace(s, o, d, pix, samp, without_roulette(fcfg))
            for c in fcfgs:
                mk.reset_launches()
                got = mk.trace(s, o, d, pix, samp, c)
                if mk.LAUNCHES[kernel] != 1:
                    raise AssertionError(f"{name}: {kernel} was not "
                                         "launched")
                want = plain_trace(s, o, d, pix, samp, c)
                if kernel == "trace_bvh" and not torch.equal(
                        got, k3_both(mk, s, (o, d, pix, samp), c, want)):
                    raise AssertionError(f"{name}: the main path's K3+K4 "
                                         "launch with fast_mc differs from "
                                         "k3_both's")
                err = float((got - want).abs().max())
                print(f"   {name} ({kernel}), roulette from bounce "
                      f"{c.russian_roulette_start}: {o.shape[0]} lanes, "
                      f"fast_mc vs plain max lane error {err:.3e}; lanes "
                      f"changed by fast_mc {int((got != full).any(1).sum())}"
                      f", by the roulette {int((got != cut).any(1).sum())}",
                      flush=True)
                if err != 0.0:
                    raise AssertionError(f"{kernel} with fast_mc differs "
                                         f"from its plain version on {name}")
                record.setdefault("fast_mc_err", []).append(err)
        for c in fcfgs:
            record["fast_mc_err"].append(segments_check(
                mk, trace_mod, rmod, grid, c, "grid5833 (K5, fast_mc, "
                f"roulette from bounce {c.russian_roulette_start})"))
        for name, s in (("bench", scenes[SCENES[0]]),
                        ("ring1000", bvh_scenes["ring1000"])):
            img = rmod.render_wavefront(s, width=160, height=120, samples=4,
                                        cfg=fcfg)
            ref = rmod.render_band(s, 0, width=160, height=120, band_h=120,
                                   samples=4, cfg=fcfg)
            image_gate(img, ref, f"fast_mc main path on {name} (160x120, "
                       "4 spp) vs dense plain path")

    with Phase("bench"):
        launches = bench(scenes[SCENES[0]], mk, "bench", slow_cut=False)
        for k in ("trace_unroll", "pixel_mask"):
            if launches[k] < 1:
                raise AssertionError(f"the main path never launched {k}")

    with Phase("bench_bvh"):
        launches_bvh = bench(bvh_scenes[BVH_SCENES[0]], mk, "bench_bvh",
                             slow_cut=True)
        for k in ("trace_bvh", "pixel_mask_bvh"):
            if launches_bvh[k] < 1:
                raise AssertionError(f"the bvh main path never launched {k}")
        if launches_bvh["trace_wide"] != launches_bvh["trace_bvh"]:
            raise AssertionError("the bvh main path did not walk 4-wide")
        if (launches_bvh["trace_bvh_ldg"] or launches_bvh["pixel_mask_ldg"]
                or launches_bvh["mask_table"]):
            raise AssertionError("the bvh main path left a table out of "
                                 f"shared memory: {launches_bvh}")

    frames = {}
    for phase, key, s, go, kernels_used in (
            ("bench_textured", "textured", ext[0][1], False,
             ("trace_unroll", "pixel_mask")),
            ("bench_smooth", "smooth", ext[2][1], False,
             ("trace_bvh", "pixel_mask_bvh")),
            ("bench_ico2561", "ico2561", ico2561, True,
             ("trace_bvh", "pixel_mask_bvh")),
            ("bench_loop", "loop", loop_scenes["icosphere"], True,
             ("trace_loop", "pixel_mask"))):
        with Phase(phase):
            got = bench(s, mk, phase, slow_cut=True, go_camera=go)
            for k in kernels_used:
                if got[k] < 1:
                    raise AssertionError(f"the {phase} frame never "
                                         f"launched {k}")
            if (got["trace_bvh_ldg"] or got["trace_loop_ldg"]
                    or got["pixel_mask_ldg"] or got["mask_table"]):
                raise AssertionError(f"the {phase} frame left its table "
                                     f"out of shared memory: {got}")
            if got["trace_guard"] != got["trace_unroll"] + got["trace_loop"]:
                raise AssertionError(f"the {phase} frame ran K1 or K7 "
                                     f"without K1-guard: {got}")
            frames[key] = (s, go, got)

    for phase, key in (("bench_stream_grid", "grid5833"),
                       ("bench_stream_mesh", "ico10241")):
        with Phase(phase):
            got = bench(stream_scenes[key], mk, phase, slow_cut=True,
                        frames=1)
            for k in ("pixel_mask_stream", "trace_stream", "trace_state"):
                if got[k] < 1:
                    raise AssertionError(f"the {phase} frame never "
                                         f"launched {k}")
            for k in ("pixel_mask_bvh", "trace_bvh", "mask_table",
                      "pixel_mask_ldg"):
                if got[k] != 0:
                    raise AssertionError(f"the {phase} frame launched {k}")
            if got["trace_wide"] != got["trace_stream"]:
                raise AssertionError(f"the {phase} frame did not walk "
                                     "4-wide")
            frames[key] = (stream_scenes[key], True, got)

    dof_frames = {}
    for phase, key, s, kernel in (
            ("bench_dof", "bench", scenes[SCENES[0]], "pixel_mask"),
            ("bench_dof_bvh", "ring1000", bvh_scenes[BVH_SCENES[0]],
             "pixel_mask_bvh"),
            ("bench_dof_stream", "grid5833", grid, "pixel_mask_stream")):
        with Phase(phase):
            got = bench(s, mk, phase, slow_cut=True, dof=True,
                        frames=1 if key == "grid5833" else 3)
            if got["mask_dof"] != got[kernel] or got[kernel] < 1:
                raise AssertionError(f"the {phase} frame did not launch "
                                     f"{kernel} with DoF: {got}")
            dof_frames[key] = got
    for phase, s, kernel in (
            ("bench_fast_mc", scenes[SCENES[0]], "trace_unroll"),
            ("bench_fast_mc_bvh", bvh_scenes[BVH_SCENES[0]], "trace_bvh")):
        with Phase(phase):
            got = bench(s, mk, phase, slow_cut=True, fast_mc=True)
            if got[kernel] < 1:
                raise AssertionError(f"the {phase} frame never launched "
                                     f"{kernel}")
            record["fast_mc_err"].append(fast_mc_frame_check(
                mk, s, fcfg, got, kernel, phase))

    with Phase("effects"):
        from raytrace_tpu_torch import scene as scene_mod
        atmo, acfg = scene_mod.load(os.path.join(
            REPO, "assets", "atmosphere_demo.json"), device=dev)
        fx_launches = effects_frame(mk, rmod, atmo, acfg, "atmosphere_demo",
                                    gate="image")
        fsil, fcfg2 = scene_mod.load(os.path.join(
            REPO, "assets", "final_silver_prism_purple_cube.json"),
            device=dev)
        for blk in (fcfg2.fog, fcfg2.effects["bloom"],
                    fcfg2.effects["vignette"]):
            blk["enabled"] = True
        fcfg2.effects.update(
            depthOfField={"enabled": True, "focalDistance": 8.0,
                          "aperture": 0.05},
            lensFlare={"enabled": True, "intensity": 0.3},
            chromaticAberration={"enabled": True, "strength": 2.0})
        # the plain path over all of this frame's 48M lanes outlasts the
        # watchdog: K1 is held to the plain guarded version on a strided
        # subset of the frame's own lanes
        effects_frame(mk, rmod, fsil, fcfg2,
                      "final_silver_prism_purple_cube", gate="lanes")
        for k in ("pixel_mask", "trace_unroll", "trace_guard"):
            if fx_launches[k] < 1:
                raise AssertionError(f"the effects frame never launched {k}")

    adaptive = {}
    with Phase("adaptive"):
        from raytrace_tpu_torch import adaptive as ad
        cfg_r = adaptive_renderer(rmod).trace_config()
        cases = [("bench", scenes[SCENES[0]],
                  ("pixel_mask", "trace_unroll", "trace_guard"), 3,
                  K3_SUBSET),
                 ("ring1000", bvh_scenes[BVH_SCENES[0]],
                  ("pixel_mask_bvh", "trace_bvh"), 3, ADAPTIVE_RING_SUBSET),
                 ("grid5833", grid,
                  ("pixel_mask_stream", "trace_stream"), 1, K5_SUBSET)]
        for key, s, kernels_used, n, sub in cases:
            adaptive[key] = adaptive_frame(mk, rmod, s, f"adaptive {key}",
                                           kernels_used, frames=n,
                                           subset=sub)
        if ad._split_spec(grid, cfg_r):
            if adaptive["grid5833"]["launches"]["trace_state"] < 1:
                raise AssertionError("the adaptive grid frame ran no ladder")
        else:
            print("   grid5833: pick_deep_caps is not 'const', so its "
                  "batches run unsplit; the full-capacity ladder runs on "
                  "the mixed scene forced into stream mode", flush=True)
            with forced_stream(mk):
                mixed = bvh_scene("mixed", dev)
                adaptive["mixed_stream"] = adaptive_frame(
                    mk, rmod, mixed, "adaptive mixed (stream)",
                    ("pixel_mask_stream", "trace_stream", "trace_state"),
                    frames=1)
        record["adaptive_accum_same"] = adaptive_equalities(
            rmod, scenes[SCENES[0]])

    with Phase("aov_denoise"):
        for key, s in (("bench", scenes[SCENES[0]]),
                       ("ring1000", bvh_scenes[BVH_SCENES[0]])):
            lin, _, var = ad.render_adaptive(
                s, width=W, height=H, cfg=cfg_r, min_spp=ADAPTIVE_MIN_SPP,
                max_spp=SPP, rel_tol=ADAPTIVE_TOL, return_variance=True,
                as_numpy=False, device=dev)
            adaptive[key]["aov_denoise_ms"] = aov_denoise(
                rmod, s, f"aov_denoise {key}", lin, var)
        r = adaptive_renderer(rmod)
        ms, img = host_ms(lambda: r.render(scenes[SCENES[0]], W, H,
                                           denoise=True))
        if img.shape != (H, W, 3) or not img.any():
            raise AssertionError("Renderer.render(denoise=True): bad image")
        print(f"   Renderer.render(denoise=True) on the bench scene "
              f"[{CARD}]: {ms:.3f} ms (one run)", flush=True)

    with Phase("checkpoint"):
        checkpoint_check(rmod, scenes[SCENES[0]])

    with Phase("diff"):
        for name in ("simple", "cube"):
            diff_card_cpu(dev, name)

    with Phase("diff_scale"):
        diff_scale(dev)

    with Phase("diff_inverse"):
        diff_inverse(dev)

    with Phase("kernels"):
        kernels = kernel_rows(mk, trace_mod, scenes[SCENES[0]],
                              bvh_scenes[BVH_SCENES[0]], cfg, launches,
                              launches_bvh, record)
        kernels += port_rows(mk, trace_mod, scenes[SCENES[0]],
                             bvh_scenes[BVH_SCENES[0]], grid, cfg, launches,
                             dof_frames, record)
        kernels += slice_rows(mk, scenes, frames, cfg, record)
        kernels += stream_rows(mk, frames, cfg, record)
        kernels += p1_rows(probe, p1_launches)
        for row in kernels:   # K3-wide in K5: the stream frames, unsplit
            if row["name"].startswith("K3-wide"):
                row.update(record["k3wide_stream"])
            if row["name"].startswith("K2 "):   # K2's other frames
                for key, m in record["k2_frames"].items():
                    row.update({f"{key}_{k}": m[k] for k in (
                        "ms", "plain", "bound", "rows", "leaf_tests")})
                    row[f"{key}_mask_stage_ms"] = m["stage"]
            if row["name"].startswith("K3 "):   # K3+K4's other frames
                for key, f in record["k3_frames"].items():
                    row.update({f"{key}_{k}": f[k] for k in (
                        "ms", "launches", "bound", "plain", "plain_lanes",
                        "split", "walk_smem_bytes")})
                    row[f"{key}_frame_launches"] = frames[key][2][
                        "trace_bvh"]
        # the launches of the adaptive path's timed frames
        on_adaptive = {"K1": ("bench", "trace_unroll"),
                       "K1-guard": ("bench", "trace_guard"),
                       "K2": ("bench", "pixel_mask"),
                       "K3": ("ring1000", "trace_bvh"),
                       "K4": ("ring1000", "trace_bvh"),
                       "K3-wide": ("ring1000", "trace_wide"),
                       "K6": ("ring1000", "pixel_mask_bvh"),
                       "K5": ("grid5833", "trace_stream"),
                       "K6-stream": ("grid5833", "pixel_mask_stream"),
                       "K1-state": ("grid5833", "trace_state")}
        for row in kernels:
            frame, key = on_adaptive.get(row["name"].split()[0],
                                         (None, None))
            if frame:
                row["adaptive_frame"] = frame
                row["adaptive_launches"] = adaptive[frame]["launches"][key]
        obj_dir.cleanup()
        regs = _build.kernel_resources(res.ptxas)
        entry = {"K1": "rt_trace_unroll_kernel", "K2": "rt_pixel_mask_kernel",
                 "K3": "rt_trace_bvh_kernel", "K4": "rt_trace_bvh_kernel",
                 "K6": "rt_pixel_mask_bvh_kernel",
                 "K7": "rt_trace_loop_kernel",
                 "K1-ext": "rt_trace_unroll_kernel",
                 "K3-wide": "rt_trace_bvh_kernel",
                 "K5": "rt_trace_stream_state_kernel",
                 "K6-stream": "rt_pixel_mask_stream_kernel",
                 "K1-state": "rt_trace_stream_state_kernel",
                 "K1-guard": "rt_trace_unroll_kernel",
                 "K2-dof": "rt_pixel_mask_dof_kernel",
                 "K6-dof": "rt_pixel_mask_bvh_kernel",
                 "K6-stream-dof": "rt_pixel_mask_stream_kernel"}
        for row in kernels:
            fn = row.pop("entry", None) or entry[row["name"].split()[0]]
            r_, stack, spill = regs.get(fn, (None, None, None))
            row.update(registers=r_, stack_bytes=stack, spill_bytes=spill)
            if row["name"].startswith("K5"):
                row["unsplit_entry_registers"] = regs.get(
                    "rt_trace_stream_kernel", (None,))[0]
            state_fn = {"K1": "rt_trace_unroll_state_kernel",
                        "K1-guard": "rt_trace_unroll_state_kernel",
                        "K3": "rt_trace_bvh_state_kernel",
                        "K7": "rt_trace_loop_state_kernel"}.get(
                            row["name"].split()[0])
            if state_fn:
                r2, st2, sp2 = regs.get(state_fn, (None, None, None))
                row.update(state_registers=r2, state_stack_bytes=st2,
                           state_spill_bytes=sp2)
            print(f"   {row['name']}: {fn} {r_} registers, {stack} B stack, "
                  f"{spill} B spills", flush=True)
        for fn in ("rt_trace_unroll_state_kernel", "rt_trace_bvh_state_kernel",
                   "rt_trace_loop_state_kernel"):
            print(f"   {fn}: {regs.get(fn)} (registers, stack bytes, "
                  "spill bytes)", flush=True)

    print(gpu_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def twin_scene(device):
    """bench/suite.py:twin_scene_dict on a leaf-size-1 tree: clusters of
    coincident spheres, where the walk's order picks the copy a lane
    shows."""
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.bench.suite import twin_scene_dict
    return scene_mod.with_accel(
        scene_mod.from_dict(twin_scene_dict(), device=device)[0],
        leaf_size=1)


def twin_spheres(device):
    """The twin scene's 96 spheres without its plane and without a tree:
    an unroll-mode scene whose brute-force order picks the copy a lane
    shows."""
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.bench.suite import twin_scene_dict
    d = twin_scene_dict()
    d["objects"] = [o for o in d["objects"] if o["type"] != "plane"]
    return scene_mod.from_dict(d, device=device, build_accel=False)[0]


def k7_equals_k1(mk, twins, cfg):
    """K7 and K1 run one policy: on the twin scene's 96 spheres without a
    BVH (exact ties) K7 - the scene forced into loop mode by a lowered
    unroll limit - gives K1's radiance and all eight work counters."""
    import torch
    if mk._kernel_mode(twins) != "unroll":
        raise AssertionError("the twin spheres are not an unroll-mode scene")
    px, o, d, pix, samp = lanes_of(twins, 64, 48, 4, cfg)
    lanes = (o, d, pix, samp)
    mk.reset_launches()
    k1, c1 = counted_launch(mk, twins, lanes, cfg)
    old_limit = mk.UNROLL_PRIM_LIMIT
    mk.UNROLL_PRIM_LIMIT = twins.prim_count - 1
    try:
        k7, c7 = counted_launch(mk, twins, lanes, cfg)
    finally:
        mk.UNROLL_PRIM_LIMIT = old_limit
    if (mk.LAUNCHES["trace_loop"], mk.LAUNCHES["trace_unroll"]) != (1, 1):
        raise AssertionError(f"twins: K7 and K1 were not launched once each: "
                             f"{mk.LAUNCHES}")
    if not (torch.equal(k7, k1) and torch.equal(c7, c1)):
        raise AssertionError("twins: K7 differs from K1 (radiance or work "
                             "counters)")
    print(f"   twin spheres ({twins.prim_count} occluders, exact ties): K7 "
          f"equal to K1 on {o.shape[0]} lanes, radiance and work counters "
          f"{[int(x) for x in c7.to(torch.int64).sum(0)]}", flush=True)


def k7_check(mk, scene, name, in_place, cfg, record):
    """K7 on the lanes of a 64x48, 4 spp frame: launched once, with its
    guard, its tables in shared memory (or, ``in_place``, read through
    __ldg); equal to itself unguarded and to the plain guarded version
    bit for bit; its time guarded and unguarded against both bounds."""
    import torch
    in_smem = mk.loop_tables_in_smem(mk.pack_tables(scene))
    if in_smem == in_place:
        raise AssertionError(f"{name}: tables in shared memory {in_smem}")
    px, o, d, pix, samp = lanes_of(scene, 64, 48, 4, cfg)
    lanes = (o, d, pix, samp)
    mk.reset_launches()
    got = mk.trace(scene, *lanes, cfg)
    if (mk.LAUNCHES["trace_loop"], mk.LAUNCHES["trace_guard"],
            mk.LAUNCHES["trace_loop_ldg"]) != (1, 1, int(in_place)):
        raise AssertionError(f"{name}: K7 launched {mk.LAUNCHES}")
    with plain_guarded():
        want = plain_trace(scene, *lanes, cfg)
    out, cg, cu = brute_both(mk, scene, lanes, cfg, want)
    if not torch.equal(got, out):
        raise AssertionError(f"{name}: K7 is not deterministic")
    err = float((got - want).abs().max())
    record.setdefault("k7_check_err", []).append(err)
    times = {}
    for guard, cnt in ((True, cg), (False, cu)):
        ops, _ = k1_ops(scene, cnt)
        _, launch = mk.prepare_trace(scene, *lanes, cfg, soft_guard=guard)
        ms = cuda_ms(launch, 3)
        times[guard] = (ms, bound(ops, o.shape[0] * 44)[0])
    gw = [int(x) for x in cg.to(torch.int64).sum(0)]
    smem = mk.trace_smem_bytes(scene)
    record.setdefault("k7_check", {})[name] = dict(
        ms=times[True][0], bound_ms=times[True][1],
        unguarded_ms=times[False][0], unguarded_bound_ms=times[False][1],
        smem_bytes=smem, guards=gw[5], flagged=gw[6])
    where = ("through __ldg" if in_place
             else f"in shared memory ({smem} B)")
    print(f"   {name}: {scene.prim_count} primitives, tables {where}, "
          f"{o.shape[0]} lanes, equal to K7 unguarded and to the plain "
          f"guarded version (max lane error {err:.3e}); guards {gw[5]}, "
          f"flagged {gw[6]}, undrawn soft rays {gw[7]} of {gw[2]}; K7 "
          f"{times[True][0]:.4f} ms guarded (bound {times[True][1]:.4f}), "
          f"{times[False][0]:.4f} ms unguarded (bound "
          f"{times[False][1]:.4f})", flush=True)


def without_wide(scene):
    """The scene with its 4-wide view taken away: the walks go binary."""
    import dataclasses
    return dataclasses.replace(scene, accel=dataclasses.replace(
        scene.accel, wide4=None))


def wide_check(mk, trace_mod, scene, cfg, what):
    """K3-wide on the lanes of a 64x48 frame, 4 spp: K3+K4 with the 4-wide
    walk against its plain version, and the same launch on the binary walk
    against its own; returns (the larger max lane error, the lanes on
    which the two walks differ by more than 1e-3)."""
    import torch
    px, o, d, pix, samp = lanes_of(scene, 64, 48, 4, cfg)
    lanes = (o, d, pix, samp)
    binary = without_wide(scene)
    mk.reset_launches()
    wide = mk.trace(scene, *lanes, cfg)
    walk2 = mk.trace(binary, *lanes, cfg)
    if (mk.LAUNCHES["trace_bvh"], mk.LAUNCHES["trace_wide"]) != (2, 1):
        raise AssertionError(f"{what}: K3 was not launched once with and "
                             f"once without the 4-wide walk: {mk.LAUNCHES}")
    errs = []
    for got, s, walk in ((wide, scene, "4-wide"), (walk2, binary, "binary")):
        want = trace_mod.trace(s, *lanes, cfg)
        if not torch.equal(got, k3_both(mk, s, lanes, cfg, want)):
            raise AssertionError(f"{what}: the main path's K3+K4 launch "
                                 f"on the {walk} walk differs from k3_both's")
        errs.append(float((got - want).abs().max()))
    differ = int(((wide - walk2).abs().amax(dim=-1) > 1e-3).sum())
    if what != "twins":   # no exact ties: the two walks take the same hits
        image_gate(pixel_image(px, wide, 64, 48, 4),
                   pixel_image(px, walk2, 64, 48, 4),
                   f"K3 4-wide vs binary walk on {what}")
    print(f"   {what}: {o.shape[0]} lanes; max lane error vs plain: 4-wide "
          f"{errs[0]:.3e}, binary {errs[1]:.3e}; the two walks differ on "
          f"{differ} lanes", flush=True)
    return max(errs), differ


def stream_scene(name, device, tmpdir=None):
    """grid-5833 ("grid") or ico-10241 ("mesh", its OBJ written into
    tmpdir) of bench/suite.py: the JAX package's stream workloads."""
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.bench import suite
    d = (suite.grid_scene_dict() if name == "grid"
         else suite.mesh_scene_dict(tmpdir))
    return scene_mod.from_dict(d, device=device)[0]


class forced_stream:
    """Within the block, a scene with a BVH past 8 primitives is a
    stream-mode scene (megakernel.MAX_BVH_KERNEL_PRIMS lowered); one
    built within it carries the stream table, on the tree it would have
    had in bvh mode."""

    def __init__(self, mk):
        self.mk = mk

    def __enter__(self):
        self.old = self.mk.MAX_BVH_KERNEL_PRIMS
        self.mk.MAX_BVH_KERNEL_PRIMS = 8

    def __exit__(self, *exc):
        self.mk.MAX_BVH_KERNEL_PRIMS = self.old
        return False


def state_check(mk, trace_mod, scene, kernel, cfg, what, split=4):
    """K1-state on a trace kernel: [0, split) with state, then
    [split, depth) from it, each against its plain version on the same
    inputs and together against one [0, depth) launch, on a strided
    subset of about K5_SUBSET lanes of a 64x48 frame. Returns the max lane
    error of the segments against the plain version."""
    import torch
    px, o, d, pix, samp = lanes_of(scene, 64, 48, 4, cfg)
    idx = torch.arange(0, o.shape[0], max(1, o.shape[0] // K5_SUBSET),
                       device=o.device)
    lanes = tuple(t[idx] for t in (o, d, pix, samp))
    whole = mk.trace(scene, *lanes, cfg)
    mk.reset_launches()
    ra, st = mk.trace(scene, *lanes, cfg, end_bounce=split,
                      return_state=True)
    rb = mk.trace(scene, st["origin"], st["direction"], *lanes[2:], cfg,
                  start_bounce=split, init_throughput=st["throughput"],
                  init_alive=st["alive"])
    if (mk.LAUNCHES[kernel], mk.LAUNCHES["trace_state"]) != (2, 2):
        raise AssertionError(f"{what}: {kernel} with state was not "
                             f"launched twice: {mk.LAUNCHES}")
    pa, pst = trace_mod.trace(scene, *lanes, cfg, end_bounce=split,
                              return_state=True)
    alive = pst["alive"] > 0
    if not torch.equal(st["alive"], pst["alive"]):
        raise AssertionError(f"{what}: alive flags differ from the plain "
                             "version")
    for k in ("origin", "direction", "throughput"):
        if not torch.equal(st[k][alive], pst[k][alive]):
            raise AssertionError(f"{what}: the state's {k} differs from "
                                 "the plain version on alive lanes")
    pb = trace_mod.trace(scene, st["origin"], st["direction"], *lanes[2:],
                         cfg, start_bounce=split,
                         init_throughput=st["throughput"],
                         init_alive=st["alive"])
    err_a = float((ra - pa).abs().max())
    err_b = float((rb - pb).abs().max())
    err = float((ra + rb - whole).abs().max())
    print(f"   {what} ({kernel}): {idx.numel()} lanes, {int(alive.sum())} "
          f"alive at bounce {split}; vs plain max: [0,{split}) {err_a:.3e}, "
          f"[{split},{cfg.max_depth}) from the same state {err_b:.3e}; "
          f"[0,{split}) + [{split},{cfg.max_depth}) vs one launch: max "
          f"lane error {err:.3e}", flush=True)
    for got, want, seg in ((ra, pa, f"[0,{split})"),
                           (rb, pb, f"[{split},{cfg.max_depth})"),
                           (ra + rb, whole, "two segments vs one launch")):
        if not torch.equal(got, want):
            image_gate(got, want, f"K1-state {what} {seg} (lanes as "
                       "pixels)")
    return max(err_a, err_b)


def render_check_stream(mk, rmod, trace_mod, scene, w=160, h=120, spp=4):
    """The stream main path at w x h, spp, depth CHECK_DEPTH against the
    dense plain path and the same path unsplit; then a frame whose first
    capacity is forced below the survivors."""
    import torch
    rcfg = trace_mod.TraceConfig(max_depth=CHECK_DEPTH, shadow_samples=SOFT)
    key = (w, h, spp, rcfg, True)
    seen = {"segment": 0, "overflow": []}

    def hook(stage, **values):
        if stage == "segment":
            seen["segment"] += 1
        if stage == "overflow":
            seen["overflow"].append(values["overflow"])

    split = rmod.pick_split(scene, rcfg)
    mk.reset_launches()
    img = rmod.render_wavefront(scene, width=w, height=h, samples=spp,
                                cfg=rcfg, hook=hook)
    print(f"   ladder {split}, deep caps {rmod.pick_deep_caps(scene)}: "
          f"{seen['segment']} segments, overflow {seen['overflow']}, "
          f"launches {mk.LAUNCHES}", flush=True)
    if seen["overflow"] != [0] or seen["segment"] != len(split) + 1:
        raise AssertionError("the ladder did not run as expected")
    rmod._SPLIT_BLACKLIST.add(key)
    try:
        unsplit = rmod.render_wavefront(scene, width=w, height=h,
                                        samples=spp, cfg=rcfg)
    finally:
        rmod._SPLIT_BLACKLIST.discard(key)
    ref = rmod.render_band(scene, 0, width=w, height=h, band_h=h,
                           samples=spp, cfg=rcfg)
    image_gate(img, ref, "stream main path vs dense plain path")
    image_gate(img, unsplit, "stream main path vs the same unsplit")
    seen["overflow"] = []
    old = rmod.SURV_FRAC, rmod.SPLIT_QUANTUM
    rmod.SURV_FRAC, rmod.SPLIT_QUANTUM = 1 << 30, 1  # first capacity: 1
    try:
        forced = rmod.render_wavefront(scene, width=w, height=h,
                                       samples=spp, cfg=rcfg, hook=hook)
        blacklisted = key in rmod._SPLIT_BLACKLIST
    finally:
        rmod.SURV_FRAC, rmod.SPLIT_QUANTUM = old
        rmod._SPLIT_BLACKLIST.discard(key)
    print(f"   first capacity forced to 1 lane: overflow "
          f"{seen['overflow']}, blacklisted {blacklisted}, equal to the "
          f"unsplit frame {torch.equal(forced, unsplit)}", flush=True)
    if not (seen["overflow"] and seen["overflow"][0] > 0 and blacklisted
            and torch.equal(forced, unsplit)):
        raise AssertionError("a forced overflow did not redo the frame "
                             "unsplit")


def tuple_at(out, idx):
    """A trace output (radiance, or radiance and state) at lanes idx."""
    if isinstance(out, tuple):
        return out[0][idx], {k: v[idx] for k, v in out[1].items()}
    return out[idx]


def past_cap_check(mk, rmod, trace_mod, dev, record):
    """A scene past the JAX package's stream cap (MAX_STREAM_KERNEL_PRIMS,
    where its Renderer leaves its kernels for a banded jnp engine): a grid
    of PAST_CAP_SIDE^3 spheres over a plane renders at 32x24, 1 spp, depth
    2 through K6-stream and K5, and K5 equals its plain version bit for
    bit on a strided subset of the frame's lanes; the Renderer renders it
    too. K6-stream reads its mask table in place, after the pre-pass,
    whose numbers go to record["past_cap_table"]."""
    import torch
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.tools.measure_mask import device_ms
    from raytrace_tpu_torch.bench.suite import grid_scene_dict
    t0 = time.perf_counter()
    s = scene_mod.from_dict(grid_scene_dict(PAST_CAP_SIDE), device=dev)[0]
    build_s = time.perf_counter() - t0
    if not (s.prim_count > mk.MAX_STREAM_KERNEL_PRIMS
            and not mk.scene_fits_kernel(s)
            and mk.require_mode(s) == "stream"):
        raise AssertionError("the past-cap scene is not past the cap in "
                             "stream mode")
    cfg = trace_mod.TraceConfig(max_depth=2, shadow_samples=SOFT, seed=0)
    seen = []

    def hook(stage, **v):
        if stage == "lane_rays":
            seen.append({k: v[k] for k in ("origin", "direction", "pix",
                                           "samp")})
        elif stage == "trace":
            seen[-1]["rad"] = v["rad"]

    mk.reset_launches()
    img = rmod.render_wavefront(s, width=32, height=24, samples=1, cfg=cfg,
                                hook=hook)
    launches = dict(mk.LAUNCHES)
    if not (launches["pixel_mask_stream"] == launches["mask_table"] == 1
            and launches["pixel_mask_ldg"] == 1
            and launches["trace_stream"] == len(seen) >= 1
            and launches["trace_bvh"] == launches["pixel_mask_bvh"] == 0):
        raise AssertionError(f"the past-cap frame launched {launches}")
    # K6-stream past the shared-memory budget: its table read in place
    got = mk.pixel_mask(s, width=32, height=24, cfg=cfg)
    if not torch.equal(got, mk.pixel_mask_plain(s, width=32, height=24,
                                                cfg=cfg)):
        raise AssertionError("K6-stream differs from its plain version past "
                             "the cap")
    nbytes, in_smem = mask_table_check(mk, s, cfg, "past-cap K6-stream",
                                       width=32, height=24)
    if in_smem:
        raise AssertionError("the past-cap mask table is in shared memory")
    _, launch = mk.prepare_pixel_mask(s, width=32, height=24, cfg=cfg)
    launch()
    ms = device_ms([launch.prepass])
    cam = launch.cam
    plain = cuda_ms(lambda: mk.mask_table_plain(s, cam, cfg), 3)
    ops, n_bytes = table_work(mk, s, cfg)
    bnd, by = bound(ops, n_bytes + nbytes)
    record["past_cap_table"] = dict(launches=launches["mask_table"], ms=ms,
                                    plain=plain, bound=bnd, by=by,
                                    table_bytes=nbytes)
    print(f"   past-cap: {s.prim_count} primitives, {s.accel.n_nodes} nodes,"
          f" a {nbytes} B mask table read in place; K6-stream equal to its "
          f"plain version; the pre-pass {ms:.4f} ms vs plain {plain:.4f} ms,"
          f" bound {bnd:.6f} ms ({by})", flush=True)
    if not (bool(torch.isfinite(img).all())
            and bool((img.sum(-1) > 0).any())):
        raise AssertionError("the past-cap frame is not finite and lit")
    lanes = tuple(torch.cat([c[k] for c in seen])
                  for k in ("origin", "direction", "pix", "samp"))
    got = torch.cat([c["rad"] for c in seen])
    idx = torch.arange(0, got.shape[0], max(1, got.shape[0] // 256),
                       device=dev)
    want = trace_mod.trace(s, *(t[idx] for t in lanes), cfg)
    if not torch.equal(got[idx], want):
        raise AssertionError("K5 differs from its plain version past the cap")
    r = rmod.Renderer(device=dev)
    r.set_samples(1)
    r.set_max_depth(2)
    if r.render(s, 32, 24).shape != (24, 32, 3):
        raise AssertionError("the Renderer's past-cap image is misshapen")
    print(f"   grid of {PAST_CAP_SIDE}^3 spheres: {s.prim_count} primitives "
          f"(cap {mk.MAX_STREAM_KERNEL_PRIMS}), leaf {s.accel.leaf_size}, "
          f"{s.accel.n_nodes} nodes, built in {build_s:.1f} s; 32x24, 1 spp, "
          f"depth 2: launches {launches}; K5 equal to its plain version on "
          f"{idx.numel()} of {got.shape[0]} lanes", flush=True)


def same(a, b):
    """Are two trace outputs (radiance, or radiance and state) equal?"""
    import torch
    if isinstance(a, tuple):
        return torch.equal(a[0], b[0]) and all(
            torch.equal(a[1][k], b[1][k]) for k in a[1])
    return torch.equal(a, b)


def same_plain(got, want):
    """Is a trace output (radiance, or radiance and state) the plain
    version's? Radiance and alive flags bit for bit, and the state of the
    lanes still alive (a dead lane keeps the state of the bounce it died
    at, which the two need not share)."""
    import torch
    if not isinstance(got, tuple):
        return torch.equal(got, want)
    alive = want[1]["alive"] > 0
    return (torch.equal(got[0], want[0])
            and torch.equal(got[1]["alive"], want[1]["alive"])
            and all(torch.equal(got[1][k][alive], want[1][k][alive])
                    for k in ("origin", "direction", "throughput")))


def plain_of(scene, lanes, cfg, **kw):
    from raytrace_tpu_torch import trace as trace_mod
    if kw:
        return trace_mod.trace(scene, *lanes, cfg, **kw)
    return plain_trace(scene, *lanes, cfg)


class same_tree:
    """Within the block, the stream scene's tree as a bvh-mode scene (its
    stream table dropped, megakernel.MAX_BVH_KERNEL_PRIMS raised past it),
    walked in the stream scene's order: K3+K4 over it must equal K5."""

    def __init__(self, mk, scene):
        self.mk, self.scene = mk, scene

    def __enter__(self):
        import dataclasses
        from raytrace_tpu_torch import bvh as bvh_mod
        self.old = self.mk.MAX_BVH_KERNEL_PRIMS
        self.mk.MAX_BVH_KERNEL_PRIMS = 1 << 30
        accel = dataclasses.replace(self.scene.accel, stream_tab=None)
        if not bvh_mod.wide_walk(self.scene.accel):
            accel = dataclasses.replace(accel, wide4=None)
        tree = dataclasses.replace(self.scene, accel=accel)
        if self.mk._kernel_mode(tree) != "bvh":
            raise AssertionError("the stream tree is not a bvh-mode scene")
        return tree

    def __exit__(self, *exc):
        self.mk.MAX_BVH_KERNEL_PRIMS = self.old
        return False


def counted_launch(mk, scene, lanes, cfg, **kw):
    """(output, per-lane work counters) of one trace launch."""
    import torch
    n_cnt = (mk.BVH_COUNTERS if mk._kernel_mode(scene) in ("bvh", "stream")
             else mk.COUNTERS)
    cnt = torch.zeros((lanes[0].shape[0], n_cnt), dtype=torch.int32,
                      device=lanes[0].device)
    out, launch = mk.prepare_trace(scene, *lanes, cfg, counters=cnt, **kw)
    launch()
    return out, cnt


def k5_both(mk, scene, lanes, cfg, want=None, check_plain=True, **kw):
    """K5 and K3+K4 on the same tree (same_tree), on the same lanes
    (``kw``: more arguments of prepare_trace); raises unless their outputs
    and work counters are equal, and (unless not ``check_plain``) unless
    the output is the plain version's (``want``, computed here when not
    given). Returns K5's output."""
    import torch
    out, cnt = counted_launch(mk, scene, lanes, cfg, **kw)
    with same_tree(mk, scene) as tree:
        k3, cnt3 = counted_launch(mk, tree, lanes, cfg, **kw)
    if not (same(out, k3) and torch.equal(cnt, cnt3)):
        raise AssertionError("K5 differs from K3+K4 on the same tree "
                             "(output or work counters)")
    if not check_plain:
        return out
    want = plain_of(scene, lanes, cfg, **kw) if want is None else want
    if not same_plain(out, want):
        raise AssertionError("K5 differs from its plain version")
    return out


def k3_both(mk, scene, lanes, cfg, want=None, **kw):
    """K3+K4 over its walk table as the main path takes it and the same
    launch reading the table in place (lowered_budget), on the same lanes
    (``kw``: more arguments of prepare_trace); raises unless their outputs
    and work counters are equal, and unless the output is the plain
    version's (``want``, computed here when not given). Returns the main
    path's output."""
    import torch
    out, cnt = counted_launch(mk, scene, lanes, cfg, **kw)
    with lowered_budget(mk):
        ldg, cnt_ldg = counted_launch(mk, scene, lanes, cfg, **kw)
    if not (same(out, ldg) and torch.equal(cnt, cnt_ldg)):
        raise AssertionError("K3+K4 over its walk table in shared memory "
                             "differs from the same launch reading it in "
                             "place (output or work counters)")
    want = plain_of(scene, lanes, cfg, **kw) if want is None else want
    if not same_plain(out, want):
        raise AssertionError("K3+K4 differs from its plain version")
    return out


def brute_both(mk, scene, lanes, cfg, want=None, **kw):
    """K1 or K7 with K1-guard (the main path's) and without it on the same
    lanes; raises unless their outputs are equal and the guarded output is
    the plain guarded version's (``want``, computed here when not given).
    Returns (guarded output, guarded counters, unguarded counters)."""
    out, cnt = counted_launch(mk, scene, lanes, cfg, **kw)
    un, cnt_un = counted_launch(mk, scene, lanes, cfg, soft_guard=False, **kw)
    if not same(out, un):
        raise AssertionError("K1-guard changed a result")
    if want is None:
        with plain_guarded():
            want = plain_of(scene, lanes, cfg, **kw)
    if not same_plain(out, want):
        raise AssertionError("the brute-force kernel differs from the plain "
                             "guarded version")
    return out, cnt, cnt_un


class lowered_budget:
    """Within the block, K3+K4 reads every walk table in place from
    global memory (megakernel.BVH_SMEM_BYTES lowered to 0), or with
    ``name`` "LOOP_SMEM_BYTES" K7 its tables."""

    def __init__(self, mk, name="BVH_SMEM_BYTES"):
        self.mk, self.name = mk, name

    def __enter__(self):
        self.old = getattr(self.mk, self.name)
        setattr(self.mk, self.name, 0)

    def __exit__(self, *exc):
        setattr(self.mk, self.name, self.old)
        return False


def ico2561_scene(device, tmpdir):
    """Two smooth icospheres of 1,280 triangles over a plane
    (bench/suite.py:mesh_scene_dict at subdivision 3): 2,561 primitives,
    bvh mode."""
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.bench import suite
    return scene_mod.from_dict(suite.mesh_scene_dict(tmpdir, subdiv=3),
                               device=device)[0]


def k3walk_check(mk, trace_mod, scenes, cfg, record):
    """The k3walk_check phase (see the module docstring)."""
    import torch
    ico, mixed = scenes["ico2561"], scenes["mixed"]
    walk = mk.pack_walk_table(ico)
    if mk._kernel_mode(ico) != "bvh" or not mk.walk_table_in_smem(walk):
        raise AssertionError("ico-2561 must be a bvh-mode scene whose walk "
                             "table fits shared memory")
    px, o, d, pix, samp = lanes_of(ico, 64, 48, 4, cfg)
    idx = torch.arange(0, o.shape[0], max(1, o.shape[0] // K5_SUBSET),
                       device=o.device)
    cases = [("ico-2561", ico, tuple(t[idx] for t in (o, d, pix, samp)), {},
              False)]
    px, o, d, pix, samp = lanes_of(mixed, 64, 48, 4, cfg)
    cases.append(("mixed, walk table read in place", mixed,
                  (o, d, pix, samp), {}, True))
    part = tuple(t[:1001] for t in (o, d, pix, samp))
    cases.append(("mixed, 1001 lanes", mixed, part, {}, False))
    _, st = mk.trace(mixed, *part, cfg, end_bounce=2, return_state=True)
    alive = st["alive"].clone()
    alive[::2] = 0.0
    kw = dict(start_bounce=2, init_throughput=st["throughput"],
              init_alive=alive)
    cases.append(("mixed, 1001 lanes from bounce 2, every other lane dead",
                  mixed, (st["origin"], st["direction"]) + part[2:], kw,
                  False))
    for name, s, lanes, kw, in_place in cases:
        want = plain_of(s, lanes, cfg, **kw)
        mk.reset_launches()
        if in_place:
            with lowered_budget(mk):
                got = k3_both(mk, s, lanes, cfg, want=want, **kw)
        else:
            got = k3_both(mk, s, lanes, cfg, want=want, **kw)
        if (mk.LAUNCHES["trace_bvh"], mk.LAUNCHES["trace_bvh_ldg"]) != (
                2, 1 + int(in_place)):
            raise AssertionError(f"{name}: K3+K4 launched {mk.LAUNCHES}")
        err = float((got - want).abs().max())
        print(f"   {name}: {lanes[0].shape[0]} lanes, walk table "
              f"{4 * mk.pack_walk_table(s).numel()} B "
              f"{'in place' if in_place else 'in shared memory'}; equal to "
              f"the plain version and to the launch reading it in place "
              f"(work counters too); max lane error vs plain {err:.3e}",
              flush=True)
        if kw and got[::2].any():
            raise AssertionError("K3+K4 gave radiance to dead lanes")
        record.setdefault("k3walk_err", []).append(err)


def k3_split(mk, scene, lanes, sizes, cfg):
    """K3+K4 at a bench frame's own chunks, ms per launch, with soft
    shadows, hard shadows only and without lights (the split of its
    walks), each timed twice in turns."""
    import dataclasses
    import torch
    from raytrace_tpu_torch import scene as scene_mod
    dev = scene.device
    dark = dataclasses.replace(scene, lights=scene_mod.Lights(
        position=torch.zeros((0, 3), device=dev),
        color=torch.zeros((0, 3), device=dev),
        intensity=torch.zeros((0,), device=dev)))
    hard = dataclasses.replace(cfg, soft_shadows=False)
    runs = {name: chunk_launches(mk, s, lanes, sizes, c)[1]
            for name, s, c in (("soft", scene, cfg), ("hard", scene, hard),
                               ("none", dark, cfg))}
    times = {k: [] for k in runs}
    for _ in range(2):
        for name in ("soft", "hard", "none"):
            times[name].append(cuda_ms(runs[name], 1) / len(sizes))
    return {name: sum(t) / 2 for name, t in times.items()}


def ladder_frame(mk, scene, cfg, launches, what):
    """K5 with K1-state at a stream bench frame: every segment launch of
    the frame's ladder re-run from its own inputs (read through the stage
    hook), timed together, and with work counters for the bound; one
    unsplit launch per chunk over the same lanes; the kernel and its plain
    version on a strided subset of about K5_SUBSET lanes, unsplit and as
    two segments. Returns a dict of the rows' numbers."""
    import torch
    from raytrace_tpu_torch import renderer as rmod
    from raytrace_tpu_torch import trace as trace_mod
    segs, chunks = [], []

    def hook(stage, **values):
        if stage == "segment":
            segs.append(values)
        elif stage == "lane_rays":
            chunks.append(values)

    rmod.render_wavefront(scene, width=W, height=H, samples=SPP, cfg=cfg,
                          hook=hook)

    def seg_kw(v, idx=None):
        last = v["b1"] >= cfg.max_depth
        kw = dict(start_bounce=v["b0"], return_state=not last,
                  end_bounce=None if last else v["b1"])
        if v["b0"] > 0:
            kw.update(init_throughput=v["throughput"], init_alive=v["alive"])
        if idx is not None:
            kw = {k: (a[idx] if isinstance(a, torch.Tensor) else a)
                  for k, a in kw.items()}
        return kw

    def prepare(v, counters=None):
        return mk.prepare_trace(scene, v["origin"], v["direction"], v["pix"],
                                v["samp"], cfg, counters=counters,
                                **seg_kw(v))

    n_launch = len(segs)
    if not (n_launch == launches["trace_stream"] == launches["trace_state"]):
        raise AssertionError(f"{what}: {n_launch} ladder segments, but the "
                             f"bench frame launched {launches}")
    prepared = [prepare(v)[1] for v in segs]
    ladder_ms = min(cuda_ms(lambda: [f() for f in prepared], 1)
                    for _ in range(2))
    # each level's launches on their own: where the ladder's time goes
    level_ms = {}
    for v, f in zip(segs, prepared):
        level_ms[v["b0"]] = level_ms.get(v["b0"], 0.0) + cuda_ms(f, 1)
    del prepared
    alive_in = {}
    for v in segs:
        n_alive = (v["origin"].shape[0] if v["alive"] is None
                   else int((v["alive"] > 0).sum()))
        alive_in[v["b0"]] = alive_in.get(v["b0"], 0) + n_alive
    print(f"   {what}: the ladder's levels, launched one at a time "
          "(first bounce: ms over the chunks, lanes alive in, lanes "
          "launched): " + "; ".join(
              f"{b}: {level_ms[b]:.2f}, {alive_in[b]}, "
              f"{sum(v['origin'].shape[0] for v in segs if v['b0'] == b)}"
              for b in sorted(level_ms)), flush=True)
    unsplit = [mk.prepare_trace(scene, c["origin"], c["direction"],
                                c["pix"], c["samp"], cfg)[1] for c in chunks]
    unsplit_ms = cuda_ms(lambda: [f() for f in unsplit], 1)
    # the same launches on the binary walk (K3-wide against it)
    binary = without_wide(scene)
    unsplit = [mk.prepare_trace(binary, c["origin"], c["direction"],
                                c["pix"], c["samp"], cfg)[1] for c in chunks]
    unsplit_binary_ms = cuda_ms(lambda: [f() for f in unsplit], 1)
    del unsplit
    # the host's share of a segment: its scene tables are packed anew at
    # every launch (megakernel.trace_tables)
    tables_ms, _ = host_ms(lambda: mk.trace_tables(scene, "stream"))
    ops = n_bytes = 0
    work = [0] * mk.BVH_COUNTERS
    tables = 4 * (scene.accel.n_nodes * 9
                  + scene.accel.stream_tab.numel())
    for v in segs:
        n = v["origin"].shape[0]
        cnt = torch.zeros((n, mk.BVH_COUNTERS), dtype=torch.int32,
                          device=v["origin"].device)
        out, launch_counted = prepare(v, cnt)
        launch_counted()
        # K5 against K3+K4 on the same tree (the plain version: below, on
        # the frame's lanes), on a strided subset of the segment's lanes
        sidx = torch.arange(0, n, max(1, n // PARTIAL_LANES),
                            device=v["origin"].device)
        sub = tuple(v[k][sidx] for k in ("origin", "direction", "pix",
                                         "samp"))
        got = k5_both(mk, scene, sub, cfg, check_plain=False,
                      **seg_kw(v, sidx))
        if not (same(got, tuple_at(out, sidx))):
            raise AssertionError(f"{what}: K5's segment from bounce "
                                 f"{v['b0']} differs from its own launch on "
                                 "a subset of its lanes")
        o_, _, w_ = k3_ops(cnt)
        ops += o_
        work = [a + b for a, b in zip(work, w_)]
        del out, got
        n_bytes += tables + n * (12 + 12 + 4 + 4 + 12) + (
            n * 16 if v["b0"] > 0 else 0) + (
            n * 40 if v["b1"] < cfg.max_depth else 0)
        del cnt
    bnd, by = bound(ops / n_launch, n_bytes / n_launch)
    # plain version, on a strided subset of the frame's lanes
    lanes = tuple(torch.cat([c[k] for c in chunks])
                  for k in ("origin", "direction", "pix", "samp"))
    n_all = lanes[0].shape[0]
    idx = torch.arange(0, n_all, max(1, n_all // K5_SUBSET),
                       device=lanes[0].device)
    sub = tuple(t[idx] for t in lanes)
    k_sub, k_launch = mk.prepare_trace(scene, *sub, cfg)
    sub_ms = cuda_ms(k_launch, 1)
    plain_ms, want = host_ms(lambda: plain_trace(scene, *sub, cfg))
    err = float((k_sub - want).abs().max())
    image_gate(k_sub, want, f"{what}: K5 at {idx.numel()} of its bench lanes "
               f"(max lane error {err:.3e})")
    b1 = segs[0]["b1"]
    sidx = torch.arange(0, n_all, max(1, n_all // STATE_SUBSET),
                        device=lanes[0].device)
    ssub = tuple(t[sidx] for t in lanes)
    (ka, st), a_launch = mk.prepare_trace(scene, *ssub, cfg, end_bounce=b1,
                                          return_state=True)
    a_launch()
    kb, b_launch = mk.prepare_trace(
        scene, st["origin"], st["direction"], *ssub[2:], cfg,
        start_bounce=b1, init_throughput=st["throughput"],
        init_alive=st["alive"])
    b_launch()
    state_sub_ms = cuda_ms(lambda: (a_launch(), b_launch()), 1)
    plain_state_ms, ((pa, pst), pb) = host_ms(lambda: (
        trace_mod.trace(scene, *ssub, cfg, end_bounce=b1, return_state=True),
        trace_mod.trace(scene, st["origin"], st["direction"], *ssub[2:], cfg,
                        start_bounce=b1, init_throughput=st["throughput"],
                        init_alive=st["alive"])))
    # K1-state against its plain version on the frame's own lanes: the
    # ladder's first segment, and the rest of the depth from its state
    alive = pst["alive"] > 0
    if not torch.equal(st["alive"], pst["alive"]):
        raise AssertionError(f"{what}: K1-state's alive flags differ from "
                             "the plain version's")
    for k in ("origin", "direction", "throughput"):
        if not torch.equal(st[k][alive], pst[k][alive]):
            raise AssertionError(f"{what}: K1-state's {k} differs from the "
                                 "plain version's on alive lanes")
    state_err = 0.0
    for got, want, seg in ((ka, pa, f"[0,{b1})"),
                           (kb, pb, f"[{b1},{cfg.max_depth})")):
        state_err = max(state_err, float((got - want).abs().max()))
        image_gate(got, want, f"{what}: K1-state {seg} at {sidx.numel()} "
                   "of its bench lanes vs plain")
    print(f"   {what}: {n_launch} ladder segments over {len(chunks)} "
          f"chunk(s), {sum(v['origin'].shape[0] for v in segs)} segment "
          f"lanes; work {work}, {ops:.4e} ops; ladder {ladder_ms:.3f} ms "
          f"({ladder_ms / n_launch:.4f} ms a launch) vs one unsplit launch "
          f"a chunk {unsplit_ms:.3f} ms; every segment equal to K3+K4 on the "
          f"same tree on a subset of its lanes (work counters too); bound "
          f"per launch {bnd:.4f} ms "
          f"({by}); on {idx.numel()} lanes: kernel {sub_ms:.3f} ms vs "
          f"plain {plain_ms:.1f} ms; on {sidx.numel()} lanes as two "
          f"segments {state_sub_ms:.3f} ms vs plain {plain_state_ms:.1f} ms "
          f"(max lane error {state_err:.3e}, {int(alive.sum())} alive at "
          f"bounce {b1}); one unsplit launch a chunk on the binary walk "
          f"{unsplit_binary_ms:.3f} ms; trace_tables on the host "
          f"{tables_ms:.3f} ms a segment", flush=True)
    return dict(launches=n_launch, ms=ladder_ms / n_launch,
                ladder_ms=ladder_ms, unsplit_ms=unsplit_ms,
                unsplit_binary_ms=unsplit_binary_ms, tables_ms=tables_ms,
                state_err=state_err,
                level_ms={str(b): v for b, v in sorted(level_ms.items())},
                chunks=len(chunks), bound=bnd, by=by, plain=plain_ms,
                err=err, plain_lanes=int(idx.numel()), ms_plain_lanes=sub_ms,
                state_lanes=int(sidx.numel()),
                state_ms_plain_lanes=state_sub_ms,
                state_plain=plain_state_ms)


def stream_rows(mk, frames, cfg, record):
    """The rows of K6-stream, K5 and K1-state at the grid-5833 bench frame,
    with ico-10241's numbers as extra keys."""
    n_px = W * H
    src = "raytrace_tpu_torch/csrc/"
    mkpy = "raytrace_tpu/ops/megakernel.py:"
    grid, _, g_launches = frames["grid5833"]
    mesh, _, m_launches = frames["ico10241"]
    k6s = mask_numbers(mk, grid, cfg)
    mask_line(f"K6-stream ({n_px} pixels, {grid.accel.n_nodes} nodes)", k6s)
    g = ladder_frame(mk, grid, cfg, g_launches, "grid-5833 frame (K5)")
    m = ladder_frame(mk, mesh, cfg, m_launches, "ico-10241 frame (K5)")
    common = dict(route="cuda", library_ms=None)
    mesh_keys = dict(mesh_ms=m["ms"],
                     mesh_unsplit_entry_ms=m["unsplit_ms"] / m["chunks"],
                     mesh_launches=m["launches"],
                     mesh_bound_ms=m["bound"], mesh_plain_ms=m["plain"],
                     mesh_plain_lanes=m["plain_lanes"],
                     mesh_ms_plain_lanes=m["ms_plain_lanes"])
    record["k3wide_stream"] = dict(
        grid_unsplit_ms=g["unsplit_ms"],
        grid_unsplit_binary_ms=g["unsplit_binary_ms"],
        mesh_unsplit_ms=m["unsplit_ms"],
        mesh_unsplit_binary_ms=m["unsplit_binary_ms"])
    return [
        # the main path launches K5's state entry only (every segment of
        # the ladder); its plain entry runs a frame unsplit after overflow
        dict(name="K5 trace_stream", source=src + "trace_stream.cu",
             replaces=mkpy + "813", launches=g["launches"],
             max_abs_err=max([g["err"], m["err"]] + record["k5_check_err"]),
             ms=g["ms"], plain_ms=g["plain"], bound_ms=g["bound"],
             bound_by=g["by"], plain_lanes=g["plain_lanes"],
             ms_plain_lanes=g["ms_plain_lanes"], chunks=g["chunks"],
             unsplit_entry_ms=g["unsplit_ms"] / g["chunks"],
             tables_host_ms=g["tables_ms"],
             **mesh_keys, **common),
        dict(name="K6-stream pixel_mask_stream", source=src + "pixel_mask.cu",
             replaces=mkpy + "2597",
             launches=g_launches["pixel_mask_stream"],
             max_abs_err=record["k6s_err"], ms=k6s["ms"],
             plain_ms=k6s["plain"], bound_ms=k6s["bound"],
             bound_by=k6s["by"], **mask_keys(k6s), **common),
        dict(name="K1-state resumable bounce loop (in K1, K3+K4, K5, K7)",
             source=src + "bounce.cuh", replaces=mkpy + "2448",
             launches=g_launches["trace_state"],
             max_abs_err=max([g["state_err"], m["state_err"]]
                             + record["kstate_err"]), ms=g["ms"],
             plain_ms=g["state_plain"], bound_ms=g["bound"],
             bound_by=g["by"], plain_lanes=g["state_lanes"],
             ms_plain_lanes=g["state_ms_plain_lanes"],
             ladder_ms=g["ladder_ms"], unsplit_ms=g["unsplit_ms"],
             level_ms=g["level_ms"], mesh_ladder_ms=m["ladder_ms"],
             mesh_unsplit_ms=m["unsplit_ms"], mesh_level_ms=m["level_ms"],
             **common),
    ]


def p1_rows(probe, launches):
    """P1's rows, one a variant: ms, plain ms and bound at the TPU tool's
    shape, ns a step at every shape."""
    rows = []
    for variant in dict.fromkeys(r["variant"] for r in probe):
        mine = [r for r in probe if r["variant"] == variant]
        tool = mine[0]
        rows.append(dict(
            name=f"P1 dma_probe {variant}", route="cuda",
            source="raytrace_tpu_torch/csrc/dma_probe.cu",
            replaces="tools/measure_dma_stream.py:67",
            entry=f"rt_dma_probe_{variant}_kernel",
            main_path="python -m raytrace_tpu_torch.tools.measure_dma_stream",
            launches=launches[variant],
            max_abs_err=max(abs(r["got"] - r["want"]) for r in mine),
            ms=tool["ms"], plain_ms=tool["plain_ms"],
            bound_ms=tool["bound_ms"], bound_by="bytes", library_ms=None,
            n_steps=tool["n_steps"],
            ns_per_step={r["shape"]: r["ns_per_step"] for r in mine}))
    return rows


class plain_guarded:
    """Within the block the plain engine's soft-shadow loop is K1-guard's
    plain version (shade.shadow_factor swapped for
    megakernel.shadow_factor_guarded): the plain guarded K1."""

    def __enter__(self):
        from raytrace_tpu_torch.ops import megakernel as mk
        from raytrace_tpu_torch.ops import shade
        self.shade, self.old = shade, shade.shadow_factor
        shade.shadow_factor = mk.shadow_factor_guarded

    def __exit__(self, *exc):
        self.shade.shadow_factor = self.old
        return False


class plain_kernels:
    """Within the block the wrappers run their plain versions on the card
    (megakernel.pixel_mask and megakernel.trace swapped): the main path as
    its plain version, for whole-frame gates. Unroll scenes only (no
    ladder)."""

    def __init__(self, mk):
        self.mk = mk

    def __enter__(self):
        import torch
        from raytrace_tpu_torch import trace as trace_mod
        mk = self.mk
        self.old = mk.pixel_mask, mk.trace
        mk.pixel_mask = lambda scene, **kw: mk.pixel_mask_plain(scene, **kw)

        def trace(scene, o, d, pix, samp, cfg, start_bounce=0, **kw):
            if start_bounce or kw:
                raise ValueError("plain_kernels: unsplit traces only")
            step = 1 << 21
            return torch.cat([trace_mod.trace(
                scene, o[i:i + step], d[i:i + step], pix[i:i + step],
                samp[i:i + step], cfg) for i in range(0, o.shape[0], step)])

        mk.trace = trace

    def __exit__(self, *exc):
        self.mk.pixel_mask, self.mk.trace = self.old
        return False


def guard_scene(name, device):
    if name == "bench":
        return load_scene(SCENES[0], device), True
    if name == "textured_mirror_demo":
        return asset_scene(name, device), False
    return golden_scene(name, device), True


def guard_check(mk, trace_mod, scene, cfg, what, go_camera):
    """K1 with K1-guard (soft_guard=1, the main path's) against K1 without
    it and against the plain guarded version, on every lane of a 64x48,
    4 spp frame, in both entries (the state entry over [0, 3)): error 0.
    Prints both entries' times and the guard's work. Returns (error,
    guarded counters, unguarded counters)."""
    import torch
    px, o, d, pix, samp = lanes_of(scene, 64, 48, 4, cfg, go_camera=go_camera)
    lanes = (o, d, pix, samp)
    n = o.shape[0]
    res = {}
    for guard in (True, False):
        cnt = torch.zeros((n, mk.COUNTERS), dtype=torch.int32,
                          device=o.device)
        out, launch = mk.prepare_trace(scene, *lanes, cfg, soft_guard=guard,
                                       counters=cnt)
        mk.reset_launches()
        launch()
        if mk.LAUNCHES["trace_guard"] != int(guard):
            raise AssertionError(f"{what}: guard {guard}, launches "
                                 f"{mk.LAUNCHES}")
        (sa, st), s_launch = mk.prepare_trace(
            scene, *lanes, cfg, soft_guard=guard, end_bounce=3,
            return_state=True)
        s_launch()
        _, t_launch = mk.prepare_trace(scene, *lanes, cfg, soft_guard=guard)
        res[guard] = dict(out=out, sa=sa, st=st, ms=cuda_ms(t_launch, 3),
                          state_ms=cuda_ms(s_launch, 3),
                          work=[int(x) for x in cnt.to(torch.int64).sum(0)])
    with plain_guarded():
        want = trace_mod.trace(scene, *lanes, cfg)
        pa, pst = trace_mod.trace(scene, *lanes, cfg, end_bounce=3,
                                  return_state=True)
    g, u = res[True], res[False]
    # the guard's own claim: guarded and unguarded K1 agree bit for bit
    same = (torch.equal(g["out"], u["out"]) and torch.equal(g["sa"], u["sa"])
            and all(torch.equal(g["st"][k], u["st"][k]) for k in pst))
    # the kernel against the plain guarded version: error 0, or (the
    # extended body's library pow and sin may round an ulp apart) the
    # image gate, as K1's other checks
    err = max(float((g["out"] - want).abs().max()),
              float((g["sa"] - pa).abs().max()))
    alive = pst["alive"] > 0
    off = g["st"]["alive"] != pst["alive"]
    for k in ("origin", "direction", "throughput"):
        off |= alive & (g["st"][k] != pst[k]).any(1)
    n_off = int(off.sum())
    if n_off > 1e-3 * n:
        raise AssertionError(f"{what}: K1-guard's state differs from the "
                             f"plain guarded version on {n_off} lanes")
    gw, uw = g["work"], u["work"]
    skipped = 1.0 - gw[6] / gw[5] if gw[5] else 0.0
    print(f"   {what}: {n} lanes, K1 guarded equal to unguarded {same} "
          f"(state entry included), vs plain guarded max lane error "
          f"{err:.3e} (lanes whose state differs: {n_off}); guards {gw[5]}, flagged {gw[6]}: {skipped:.4f} of "
          f"the (lane, light, occluder) triples skipped; soft rays asked "
          f"{gw[2]}, undrawn {gw[7]}; occlusion tests (hard + soft) guarded "
          f"{gw[3] + gw[4]} vs unguarded {uw[3] + uw[4]}; ms guarded "
          f"{g['ms']:.4f} vs unguarded {u['ms']:.4f}, state entry "
          f"{g['state_ms']:.4f} vs {u['state_ms']:.4f}", flush=True)
    if not same:
        raise AssertionError(f"{what}: K1-guard changed a result")
    if err > 0.0:
        image_gate(pixel_image(px, g["out"], 64, 48, 4),
                   pixel_image(px, want, 64, 48, 4),
                   f"K1-guard {what} vs plain guarded")
    return err, gw, uw


def dof_cfg(trace_mod, lens, **kw):
    L, F = lens
    return trace_mod.TraceConfig(depth_of_field=True, dof_lens_radius=L,
                                 dof_focus_distance=F, **kw)


def dof_dense_check(mk, rmod, scene, cfg, what, w=160, h=120):
    """The DoF mask (its kernel) against the dense plain path: every pixel
    that some of DOF_DENSE lens samples hits (the exact primary any-hit,
    the tree walked where there is one) must lie in the mask."""
    import torch
    from raytrace_tpu_torch.ops import intersect
    mask = mk.pixel_mask(scene, width=w, height=h, cfg=cfg)
    dev = mask.device
    dense = torch.zeros(w * h, dtype=torch.bool, device=dev)
    rows = max(1, (1 << 20) // (w * DOF_DENSE))
    for y0 in range(0, h, rows):
        px = torch.arange(y0 * w, min(h, y0 + rows) * w, device=dev)
        pix, samp = rmod._lane_ids(px, DOF_DENSE)
        o, d = rmod._lane_rays(scene, pix, samp, width=w, height=h, cfg=cfg,
                               go_camera=True)
        hit = intersect.any_hit(scene.geometry, o.contiguous(), d, 1e-3,
                                intersect.BIG, accel=scene.accel, exact=True)
        dense[px] = hit.reshape(-1, DOF_DENSE).any(1)
    missing = int((dense & ~mask).sum())
    print(f"   {what}: L={cfg.dof_lens_radius}, F={cfg.dof_focus_distance} at "
          f"{w}x{h}: mask {int(mask.sum())}, hit by some of {DOF_DENSE} lens "
          f"samples {int(dense.sum())}, missing {missing}", flush=True)
    if missing or not dense.any():
        raise AssertionError(f"{what}: the DoF mask is not conservative")


def segments_check(mk, trace_mod, rmod, scene, cfg, what, w=64, h=48,
                   spp=4):
    """Every segment of a stream main-path frame's split ladder (K5 with
    K1-state), re-run from its own inputs, against its plain version on a
    strided subset of at most K5_SUBSET of its lanes: error 0."""
    import torch
    segs = []

    def hook(stage, **values):
        if stage == "segment":
            segs.append(values)

    mk.reset_launches()
    rmod.render_wavefront(scene, width=w, height=h, samples=spp, cfg=cfg,
                          hook=hook)
    if len(segs) < 2 or mk.LAUNCHES["trace_stream"] != len(segs):
        raise AssertionError(f"{what}: no ladder ran: {mk.LAUNCHES}")
    err = 0.0
    for v in segs:
        n = v["origin"].shape[0]
        idx = torch.arange(0, n, max(1, n // K5_SUBSET),
                           device=v["origin"].device)
        last = v["b1"] >= cfg.max_depth
        kw = dict(start_bounce=v["b0"],
                  end_bounce=None if last else v["b1"])
        if v["b0"] > 0:
            kw.update(init_throughput=v["throughput"][idx],
                      init_alive=v["alive"][idx])
        args = tuple(v[k][idx] for k in ("origin", "direction", "pix",
                                         "samp"))
        got = mk.trace(scene, *args, cfg, **kw)
        want = trace_mod.trace(scene, *args, cfg, **kw)
        err = max(err, float((got - want).abs().max()))
    print(f"   {what}: {len(segs)} ladder segments, max lane error against "
          f"the plain version {err:.3e}", flush=True)
    if err != 0.0:
        raise AssertionError(f"{what}: a segment differs from its plain "
                             "version")
    return err


def effects_frame(mk, rmod, scene, scfg, what, gate):
    """Renderer.render(scene, W, H, scene_config) with the scene's look-at
    camera through the main path and the effects; stage times of one
    frame (render, then each effect that runs, then the tone map and the
    copy). ``gate`` "image": the linear image after the effects against
    the plain path's (plain_kernels) under the image gate; "lanes": the
    frame's K1 launches against the plain guarded version on a strided
    subset of their lanes (frame_lanes_check). Returns the entry point's
    launch counts."""
    import torch
    from raytrace_tpu_torch.ops import tonemap
    r = rmod.Renderer(device=torch.device("cuda"))
    r.go_camera = False
    r.render(scene, W, H, scfg)  # warm-up
    mk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = r.render(scene, W, H, scfg)
    torch.cuda.synchronize()
    frame = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    if img.shape != (H, W, 3) or not img.any():
        raise AssertionError(f"{what}: bad image")
    ms = {}
    last = [time.perf_counter()]

    def mark(stage, **values):
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[stage] = round((now - last[0]) * 1e3, 3)
        last[0] = now

    lin = r.render_linear_device(scene, W, H)
    mark("render")
    out = r._apply_scene_effects(scene, lin, W, H, scfg, hook=mark)
    tonemap.tonemap_rgb8(out).cpu()
    mark("tonemap_copy")
    print(f"   {what} [{CARD}]: {r.samples} spp, depth {r.max_depth}: frame "
          f"{frame:.4f} s; stages of one frame, ms (host clock, "
          f"synchronised): {ms}; launches {launches}", flush=True)
    if gate == "lanes":
        frame_lanes_check(mk, scene, r.trace_config(), r.samples, False,
                          launches, "trace_unroll", f"{what} (K1, guarded)",
                          exact=False, guarded=True)
        return launches
    got = r._apply_scene_effects(scene, lin, W, H, scfg)
    with plain_kernels(mk):
        lin_p = r.render_linear_device(scene, W, H)
    want = r._apply_scene_effects(scene, lin_p, W, H, scfg)
    image_gate(got, want, f"{what} at {r.samples} spp, after the effects, "
               "vs the plain path")
    return launches


# ------------------------------------------------ the production loop ----

# Adaptive settings of the adaptive phase (Renderer.render_adaptive's
# defaults; the cap is SPP).
ADAPTIVE_MIN_SPP, ADAPTIVE_TOL = 8, 0.02
# The Tensor methods that bring a CUDA tensor's value to the host.
HOST_READS = ("item", "tolist", "cpu", "__int__", "__float__", "__bool__",
              "__index__")


class counted_reads:
    """Within the block every read of a CUDA tensor to the host (a call of
    a HOST_READS method) is counted under the stage of render_adaptive's
    hook it follows: "before", a round's index, or "finish"."""

    def __init__(self):
        self.where = "before"
        self.counts = {}

    def mark(self, where):
        self.where = where

    def __enter__(self):
        import torch
        self.saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}

        def wrap(orig):
            def read(t, *a, **k):
                if t.is_cuda:
                    self.counts[self.where] = self.counts.get(self.where,
                                                              0) + 1
                return orig(t, *a, **k)
            return read

        for n, orig in self.saved.items():
            setattr(torch.Tensor, n, wrap(orig))
        return self

    def __exit__(self, *exc):
        import torch
        for n, orig in self.saved.items():
            setattr(torch.Tensor, n, orig)
        return False


def adaptive_renderer(rmod):
    import torch
    r = rmod.Renderer(device=torch.device("cuda"))
    r.set_samples(SPP)
    r.set_max_depth(DEPTH)
    return r


def adaptive_frame(mk, rmod, scene, what, kernels, frames=3,
                   subset=K3_SUBSET):
    """Renderer.render_adaptive at 800x600, cap SPP, depth 50, min_spp 8,
    rel_tol 0.02, device accumulation: one warm-up, then ``frames`` timed
    frames (launch counts reset just before the first and read just
    after it: each of ``kernels`` must have launched); then one run
    through the stage hook, which must give the same spp map: its test
    rounds, the k read at each, the reads of CUDA tensors to the host by
    round (counted_reads: one on a test round, none on the others), and
    the trace launches of the first batch with s0 > 0 (adaptive_batch,
    on about ``subset`` of its lanes). Returns the numbers for the
    record."""
    import torch
    from raytrace_tpu_torch import adaptive as ad
    r = adaptive_renderer(rmod)
    kw = dict(min_spp=ADAPTIVE_MIN_SPP, rel_tol=ADAPTIVE_TOL)
    split = ad._split_spec(scene, r.trace_config())
    t0 = time.perf_counter()
    r.render_adaptive(scene, W, H, **kw)  # warm-up
    warm = time.perf_counter() - t0
    times = []
    for i in range(frames):
        if i == 0:
            mk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, spp = r.render_adaptive(scene, W, H, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(mk.LAUNCHES)
    for k in kernels:
        if launches[k] < 1:
            raise AssertionError(f"{what}: the adaptive path never launched "
                                 f"{k}: {launches}")
    if img.shape != (H, W, 3) or not img.any():
        raise AssertionError(f"{what}: bad adaptive image")
    if r.benchmark_data.samples != float(spp.mean()):
        raise AssertionError(f"{what}: benchmark samples is not the mean spp")
    best = sorted(times)[len(times) // 2]
    taken = int(spp.astype("int64").sum())
    print(f"   {what} [{CARD}]: adaptive frame seconds "
          f"{[round(t, 4) for t in times]} (warm-up {warm:.3f}); median "
          f"{best * 1e3:.3f} ms; mean spp {float(spp.mean()):.4f} (cap "
          f"{SPP}, min {ADAPTIVE_MIN_SPP}, pixels sampled "
          f"{int((spp > 0).sum())}); samples taken {taken} = "
          f"{taken / best:.4e} samples/s; split {split}; launches "
          f"{launches}", flush=True)

    rounds, reads = [], counted_reads()
    seen = {"lanes": [], "rad": [], "segs": [], "ov": [], "compact": []}
    stage_ms, last = {}, [0.0]

    def hook(stage, **v):
        torch.cuda.synchronize()   # a stage ends here (no host read)
        now = time.perf_counter()
        stage_ms[stage] = stage_ms.get(stage, 0.0) + (now - last[0]) * 1e3
        last[0] = now
        if stage == "round":
            rounds.append({"s0": v["s0"], "batch": v["batch"],
                           "test": v["test"], "k": None})
            reads.mark(len(rounds) - 1)
        elif stage == "k_read":
            rounds[-1]["k"] = v["k"]
        elif stage == "finish":
            reads.mark("finish")
        elif stage == "split_compact":
            seen["compact"].append((v["survivors"], v["cap"]))
        elif stage == "trace":
            seen["ov"].append(v["overflow"])
        if not rounds or len(rounds) != 2:
            return
        if stage == "lane_rays":   # the second batch: s0 > 0
            seen["lanes"].append(tuple(v[k] for k in ("origin", "direction",
                                                      "pix", "samp")))
        elif stage == "trace":
            seen["rad"].append(v["rad"])
        elif stage == "segment":
            seen["segs"].append(dict(v, rad=v["rad"].clone()))

    with reads:
        torch.cuda.synchronize()
        t0 = last[0] = time.perf_counter()
        _, spp2 = r.render_adaptive(scene, W, H, hook=hook, **kw)
        hooked = (time.perf_counter() - t0) * 1e3
    stage_ms["tail"] = hooked - sum(stage_ms.values())
    if not (spp2 == spp).all():
        raise AssertionError(f"{what}: the hooked run took other samples")
    print(f"   {what}: stages of the hooked frame, ms (each ended by a "
          f"synchronise; the time up to each hook, summed over the "
          f"batches; tail = finish, tone map, copy): "
          f"{ {k: round(t, 3) for k, t in stage_ms.items()} }, frame "
          f"{hooked:.3f}", flush=True)
    tests = [x for x in rounds if x["test"]]
    per_round = {i: reads.counts.get(i, 0) for i in range(len(rounds))}
    bad = [i for i, x in enumerate(rounds)
           if per_round[i] != (1 if x["test"] else 0)]
    print(f"   {what}: {len(rounds)} batches (s0, batch): "
          f"{[(x['s0'], x['batch']) for x in rounds]}; test rounds "
          f"{len(tests)}, k read at each (s0 after the batch: k): "
          f"{[(x['s0'] + x['batch'], x['k']) for x in tests]}; host reads "
          f"by round {per_round}, before the first "
          f"{reads.counts.get('before', 0)}, after the last "
          f"{reads.counts.get('finish', 0)}", flush=True)
    if bad:
        raise AssertionError(f"{what}: rounds {bad} read the device other "
                             "than once a test round")
    ov = [int(o) for o in seen["ov"]]
    over = [(int(s), c) for s, c in seen["compact"] if int(s) > c]
    if split:
        print(f"   {what}: ladder levels over all batches "
              f"{len(seen['compact'])}, overflow of every trace {set(ov)}, "
              f"levels past their capacity {len(over)}", flush=True)
        if any(ov) or over or not seen["compact"]:
            raise AssertionError(f"{what}: the full-capacity ladder "
                                 "overflowed or did not run")
    err = adaptive_batch(scene, r.trace_config(), seen, split, what, subset)
    return {"frame_ms": best * 1e3, "frame_s": times, "mean_spp":
            float(spp.mean()), "samples_taken": taken,
            "samples_per_s": taken / best, "rounds": len(rounds),
            "k_reads": [x["k"] for x in tests], "split": repr(split),
            "launches": launches, "max_abs_err": err,
            "stage_ms": stage_ms}


def adaptive_batch(scene, cfg, seen, split, what, subset):
    """The trace launches of an adaptive batch with s0 > 0, read through
    the hook, against their plain version: unsplit, the radiance on a
    strided subset of about ``subset`` of the batch's lanes; through the
    ladder, each segment's radiance and state on a strided subset of about
    K5_SUBSET of its lanes (same_plain). Error 0; returns it."""
    import torch
    from raytrace_tpu_torch import trace as trace_mod
    o, d, pix, samp = (torch.cat(t) for t in zip(*seen["lanes"]))
    s0 = int(samp.min())
    if s0 <= 0:
        raise AssertionError(f"{what}: the checked batch starts at s0 0")
    if not split:
        rad = torch.cat(seen["rad"])
        n = o.shape[0]
        idx = torch.arange(0, n, max(1, n // subset), device=o.device)
        want = plain_trace(scene, o[idx], d[idx], pix[idx], samp[idx], cfg)
        err = float((rad[idx] - want).abs().max())
        print(f"   {what}: batch at s0 {s0}, {n} lanes; at {idx.numel()} of "
              f"them max lane error against the plain version {err:.3e}",
              flush=True)
    else:
        err = 0.0
        for v in seen["segs"]:
            n = v["origin"].shape[0]
            idx = torch.arange(0, n, max(1, n // K5_SUBSET),
                               device=v["origin"].device)
            last = v["state"] is None
            kw = dict(start_bounce=v["b0"],
                      end_bounce=None if last else v["b1"],
                      return_state=not last)
            if v["b0"] > 0:
                kw.update(init_throughput=v["throughput"][idx],
                          init_alive=v["alive"][idx])
            args = tuple(v[k][idx] for k in ("origin", "direction", "pix",
                                             "samp"))
            want = trace_mod.trace(scene, *args, cfg, **kw)
            got = v["rad"][idx] if last else (
                v["rad"][idx], {k: t[idx] for k, t in v["state"].items()})
            rad_want = want if last else want[0]
            err = max(err, float((got if last else got[0])
                                 .sub(rad_want).abs().max()))
            if not same_plain(got, want):
                raise AssertionError(f"{what}: ladder segment [{v['b0']}, "
                                     f"{v['b1']}) differs from its plain "
                                     "version")
        print(f"   {what}: batch at s0 {s0}, {o.shape[0]} lanes, "
              f"{len(seen['segs'])} ladder segments, each on at most "
              f"{K5_SUBSET} of its lanes: max lane error against the plain "
              f"version {err:.3e} (state of alive lanes equal)", flush=True)
    if err != 0.0:
        raise AssertionError(f"{what}: an adaptive batch's trace differs "
                             "from its plain version")
    return err


def adaptive_equalities(rmod, scene):
    """On the bench scene at 800x600: rel_tol = abs_tol = 0 with min_spp =
    max_spp = 8 (two batches of 4) against render_wavefront at 8 spp; the
    bench settings in device against host accumulation, spp maps equal on
    at least 99.9% of pixels. Both under the image gate."""
    import torch
    from raytrace_tpu_torch import adaptive as ad
    dev = torch.device("cuda")
    cfg = adaptive_renderer(rmod).trace_config()
    img, spp = ad.render_adaptive(
        scene, width=W, height=H, cfg=cfg, min_spp=8, max_spp=8, batch=4,
        rel_tol=0.0, abs_tol=0.0, as_numpy=False, device=dev)
    ref = rmod.render_wavefront(scene, width=W, height=H, samples=8, cfg=cfg)
    if not bool((spp[spp > 0] == 8).all()):
        raise AssertionError("tolerance 0: a pixel stopped before 8 spp")
    image_gate(img, ref, "adaptive, tolerance 0, 8 spp, vs render_wavefront "
               "at 8 spp")
    kw = dict(width=W, height=H, cfg=cfg, min_spp=ADAPTIVE_MIN_SPP,
              max_spp=SPP, batch=8, rel_tol=ADAPTIVE_TOL, as_numpy=False,
              device=dev)
    out = {}
    for accum in ("device", "host"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[accum] = ad.render_adaptive(scene, accum=accum, **kw)
        torch.cuda.synchronize()
        out[accum] += (time.perf_counter() - t0,)
    (img_d, spp_d, t_d), (img_h, spp_h, t_h) = out["device"], out["host"]
    same = float((spp_d == spp_h).float().mean())
    print(f"   device vs host accumulation: spp maps equal on {same:.6f} of "
          f"the pixels, mean spp {float(spp_d.float().mean()):.4f} / "
          f"{float(spp_h.float().mean()):.4f}; seconds {t_d:.4f} / "
          f"{t_h:.4f}", flush=True)
    if same < 0.999:
        raise AssertionError("device and host accumulation decide apart")
    image_gate(img_d, img_h, "adaptive, device vs host accumulation")
    return same


def aov_denoise(rmod, scene, what, lin, var):
    """render_aovs and denoise (dense and a-trous, with and without the
    variance map) at 800x600 on the card, each against the same call with
    device="cpu" on the same inputs: hit, mat_id and front_face equal, the
    float buffers and the filtered image within an absolute 1e-5. ms of
    each card call (median of 3, synchronised). Returns the ms."""
    import torch
    from raytrace_tpu_torch import aov, denoising
    dev = torch.device("cuda")
    ms = {}

    def timed(key, fn):
        fn()  # warm-up
        runs = [host_ms(fn) for _ in range(3)]
        ms[key] = sorted(t for t, _ in runs)[1]
        return runs[0][1]

    a = timed("aovs", lambda: aov.render_aovs(
        scene, width=W, height=H, as_numpy=False, device=dev))
    a_cpu = aov.render_aovs(scene.to("cpu"), width=W, height=H,
                            as_numpy=False, device="cpu")
    errs = {}
    for k in ("hit", "mat_id", "front_face"):
        if not torch.equal(a[k].cpu(), a_cpu[k]):
            raise AssertionError(f"{what}: AOV {k} differs on the CPU")
    for k in ("depth", "position", "normal", "albedo"):
        errs[k] = float((a[k].cpu() - a_cpu[k]).abs().max())
    a_h = {k: v.cpu() for k, v in a.items()}
    for passes in (1, 3):
        for v in (None, var):
            key = f"denoise_p{passes}{'_var' if v is not None else ''}"
            got = timed(key, lambda: denoising.denoise(
                lin, a, variance=v, passes=passes, as_numpy=False,
                device=dev))
            want = denoising.denoise(
                lin.cpu(), a_h, variance=None if v is None else v.cpu(),
                passes=passes, as_numpy=False, device="cpu")
            errs[key] = float((got.cpu() - want).abs().max())
    print(f"   {what} [{CARD}]: ms (median of 3, synchronised) "
          f"{ {k: round(t, 3) for k, t in ms.items()} }; max abs error "
          f"against the CPU {errs}; hit pixels {int(a['hit'].sum())}",
          flush=True)
    bad = {k: e for k, e in errs.items() if not e <= 1e-5}
    if bad:
        raise AssertionError(f"{what}: the card differs from the CPU by more "
                             f"than 1e-5: {bad}")
    return ms


def diff_card_cpu(dev, name):
    """render_and_grad on the card against the same call on the CPU; the
    scan loop's image against the while loop's on the card."""
    import torch
    from raytrace_tpu_torch import diff
    from raytrace_tpu_torch import renderer as rmod
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch import trace as trace_mod
    from raytrace_tpu_torch.bench.suite import diff_scene_dict
    w, h, spp = 12, 8, 2
    cfg = trace_mod.TraceConfig(max_depth=3, shadow_samples=2)
    out, ms = {}, {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        s = scene_mod.from_dict(diff_scene_dict(name), device=where)[0]
        diff.render_and_grad(s, w, h, samples=spp, cfg=cfg)  # warm-up
        ms[key], out[key] = host_ms(lambda: diff.render_and_grad(
            s, w, h, samples=spp, cfg=cfg))
        if key == "card":
            while_img = rmod.render_band(s, 0, width=w, height=h, band_h=h,
                                         samples=spp, cfg=cfg)
    (img, grads), (img_c, grads_c) = out["card"], out["cpu"]
    img_err = float((img.cpu() - img_c).abs().max())
    if not img_err <= 1e-5:
        raise AssertionError(f"diff {name}: the card's image is {img_err} "
                             "from the CPU's")
    if not torch.equal(while_img, img):
        raise AssertionError(f"diff {name}: the scan loop's image differs "
                             "from the while loop's on the card")
    worst = 0.0
    for g, sub in grads.items():
        for f, v in sub.items():
            v = v.cpu()
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"diff {name}: {g}.{f} not finite")
            torch.testing.assert_close(v, grads_c[g][f], rtol=1e-4,
                                       atol=1e-6, msg=f"diff {name}: {g}.{f}"
                                       " on the card against the CPU")
            if v.numel():  # the error over its allowance, <= 1
                err = (v - grads_c[g][f]).abs() / (
                    1e-6 + 1e-4 * grads_c[g][f].abs())
                worst = max(worst, float(err.max()))
    print(f"   {name} [{CARD}]: image max error {img_err:.3e} against the "
          f"CPU, scan = while bit for bit; gradient error at most "
          f"{worst:.3f} of its allowance (rtol 1e-4, atol 1e-6); "
          f"render_and_grad {ms['card']:.1f} ms on the card, "
          f"{ms['cpu']:.1f} ms on the host's CPU", flush=True)


def diff_scale(dev):
    """The four rows of tools/measure_grad_scale.py on the card."""
    from raytrace_tpu_torch.tools import measure_grad_scale as mgs
    with tempfile.TemporaryDirectory() as tmp:
        scenes = mgs.scenes(dev, tmp)
        rows = {}
        for name, keep in mgs.ROWS:
            rows[name, keep] = mgs.measure_row(name, scenes[name], keep)
            print(f"   [{CARD}] {mgs.line(rows[name, keep])}", flush=True)
    worst = mgs.accel_agrees(rows["grid-1001", True],
                             rows["grid-1001", False])
    print(f"   [{CARD}] grid-1001: keep_accel image equals brute force bit "
          f"for bit; material and light gradients within {worst:.3e} "
          "relative", flush=True)


def diff_inverse(dev):
    """tools/inverse_rendering.py's loop on the card."""
    from raytrace_tpu_torch.tools import inverse_rendering as inv
    out = inv.run(200, dev)
    losses = out["losses"]
    print(f"   [{CARD}] inverse rendering, 200 steps at {inv.W}x{inv.H}, "
          f"{inv.SPP} spp, depth {inv.CFG.max_depth}: {out['ms_per_step']:.3f}"
          f" ms a step; loss at steps 0, 25, 199: {losses[0]:.4e}, "
          f"{losses[25]:.4e}, {losses[199]:.4e}; intensity "
          f"{out['recovered']:.4f} (true {out['true']}, error "
          f"{out['rel_err']:.2%})", flush=True)
    if not out["rel_err"] < 0.1:
        raise AssertionError("inverse rendering did not recover the "
                             "intensity within 10%")


def checkpoint_check(rmod, scene):
    """On the bench scene at 160x120, cap 32, min_spp 4, in both
    accumulation modes: render_adaptive interrupted (adaptive._save_ckpt
    raising after its second call) and resumed equals the uninterrupted
    render bit for bit; a changed split spec, batch or scene is refused;
    render_with_checkpoints resumed to the uninterrupted image."""
    import numpy as np
    import torch
    from raytrace_tpu_torch import adaptive as ad
    from raytrace_tpu_torch import parallel
    dev = torch.device("cuda")
    cfg = adaptive_renderer(rmod).trace_config()
    kw = dict(width=160, height=120, cfg=cfg, min_spp=4, max_spp=32,
              batch=4, rel_tol=ADAPTIVE_TOL, device=dev)

    class Interrupted(Exception):
        pass

    real = ad._save_ckpt
    other = with_lights(scene, 3)
    with tempfile.TemporaryDirectory() as tmp:
        for accum in ("device", "host"):
            ref = ad.render_adaptive(scene, accum=accum, **kw)
            path = os.path.join(tmp, f"{accum}.ckpt.npz")
            calls = [0]

            def dying(*a, **k):
                real(*a, **k)
                calls[0] += 1
                if calls[0] >= 2:
                    raise Interrupted

            ad._save_ckpt = dying
            try:
                ad.render_adaptive(scene, accum=accum, checkpoint_path=path,
                                   **kw)
                raise AssertionError("the patched checkpoint did not fire")
            except Interrupted:
                pass
            finally:
                ad._save_ckpt = real
            got = ad.render_adaptive(scene, accum=accum,
                                     checkpoint_path=path, **kw)
            for a, b, name in zip(got, ref, ("image", "spp map")):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{accum}: the resumed {name} "
                                         "differs")
            refused = []
            old_spec = ad._split_spec
            for label, s, extra in (("split spec", scene, {}),
                                    ("batch", scene, {"batch": 2}),
                                    ("scene", other, {})):
                if label == "split spec":
                    ad._split_spec = lambda scene, cfg: (4, 7)
                try:
                    ad.render_adaptive(s, accum=accum, checkpoint_path=path,
                                       **dict(kw, **extra))
                except ValueError:
                    refused.append(label)
                finally:
                    ad._split_spec = old_spec
            print(f"   {accum} accumulation: resumed after 2 checkpoints "
                  f"equals the uninterrupted render bit for bit (mean spp "
                  f"{float(ref[1].mean()):.4f}); refused: {refused}",
                  flush=True)
            if refused != ["split spec", "batch", "scene"]:
                raise AssertionError(f"{accum}: a changed run was not "
                                     f"refused: {refused}")

        def fresh():
            r = rmod.Renderer(device=dev)
            r.set_max_depth(DEPTH)
            return r

        path = os.path.join(tmp, "render.npz")
        full = parallel.render_with_checkpoints(
            fresh(), scene, 160, 120, total_samples=8, samples_per_round=4)
        parallel.render_with_checkpoints(
            fresh(), scene, 160, 120, total_samples=4, samples_per_round=4,
            checkpoint_path=path)
        resumed = parallel.render_with_checkpoints(
            fresh(), scene, 160, 120, total_samples=8, samples_per_round=4,
            checkpoint_path=path)
        if not np.array_equal(resumed, full) or not resumed.any():
            raise AssertionError("render_with_checkpoints resumed to another "
                                 "image")
        print("   render_with_checkpoints: 4 + 4 samples resumed equal 8 in "
              "one run bit for bit", flush=True)


def without_roulette(cfg):
    """fast_mc's throughput cutoff alone: what roulette changes shows
    against it."""
    import dataclasses
    return dataclasses.replace(cfg, russian_roulette_start=None)


def frame_lanes_check(mk, scene, cfg, samples, go_camera, launches, kernel,
                      what, exact=True, guarded=False):
    """The trace kernel at a timed frame's own lanes and chunks (the frame
    launched ``kernel`` once a chunk, as ``launches`` must show): its
    output against the plain version (the plain guarded one for
    ``guarded``) on a strided subset of about K3_SUBSET lanes, at error 0
    (else, unless ``exact``, under the image gate, lanes as pixels).
    Returns (error, the frame's lanes, their chunk sizes, the output)."""
    import contextlib
    import torch
    px, o, d, pix, samp, sizes = lanes_of(scene, W, H, samples, cfg,
                                          chunks=True, go_camera=go_camera)
    if launches[kernel] != len(sizes):
        raise AssertionError(f"{what}: the frame launched {kernel} "
                             f"{launches[kernel]} times, not its chunk "
                             f"count {len(sizes)}")
    lanes = (o, d, pix, samp)
    out, launch_all = chunk_launches(mk, scene, lanes, sizes, cfg)
    launch_all()
    got = out()
    n = o.shape[0]
    idx = torch.arange(0, n, max(1, n // K3_SUBSET), device=o.device)
    with plain_guarded() if guarded else contextlib.nullcontext():
        want = plain_trace(scene, *(t[idx] for t in lanes), cfg)
    err = float((got[idx] - want).abs().max())
    print(f"   {what}: {n} lanes in {len(sizes)} launch(es); at {idx.numel()} "
          f"of them max lane error against the plain version {err:.3e}",
          flush=True)
    if err > 0.0:
        if exact:
            raise AssertionError(f"{what}: the kernel differs from its "
                                 "plain version")
        image_gate(got[idx], want, f"{what} at {idx.numel()} lanes")
    return err, lanes, sizes, got


def fast_mc_frame_check(mk, scene, cfg, launches, kernel, what):
    """A fast_mc bench frame's trace launches against the plain version at
    error 0 (frame_lanes_check), and against the same launches without
    the roulette: the roulette from bounce 8 must change some lanes."""
    err, lanes, sizes, got = frame_lanes_check(
        mk, scene, cfg, SPP, True, launches, kernel, f"{what} ({kernel})")
    cut, launch_all = chunk_launches(mk, scene, lanes, sizes,
                                     without_roulette(cfg))
    launch_all()
    changed = int((got != cut()).any(1).sum())
    print(f"   {what}: lanes changed by the roulette from bounce "
          f"{cfg.russian_roulette_start}: {changed} of {got.shape[0]}",
          flush=True)
    if changed == 0:
        raise AssertionError(f"{what}: the roulette changed no lane")
    return err


def loop_ring_scene(n, device):
    """ring-n of bench/suite.py without a BVH (loop mode)."""
    from raytrace_tpu_torch import scene as scene_mod
    from raytrace_tpu_torch.bench.suite import ring_scene_dict
    return scene_mod.from_dict(ring_scene_dict(n), device=device,
                               build_accel=False)[0]


def frame_kernel(mk, scene, cfg, go_camera, what, subset=K3_SUBSET):
    """The trace kernel of a bench frame, at the main path's own chunks of
    that frame's lanes: checks, time per launch, plain time on a strided
    subset of about ``subset`` lanes, bound from the work counters.
    Returns a dict of the row's numbers."""
    import torch
    from raytrace_tpu_torch import trace as trace_mod
    dev = torch.device("cuda")
    mode = mk._kernel_mode(scene)
    px, o, d, pix, samp, sizes = lanes_of(scene, W, H, SPP, cfg, chunks=True,
                                          go_camera=go_camera)
    lanes = (o, d, pix, samp)
    n, n_launch = o.shape[0], len(sizes)
    idx = torch.arange(0, n, max(1, n // subset), device=dev)
    sub = tuple(t[idx] for t in lanes)
    out, launch_all = chunk_launches(mk, scene, lanes, sizes, cfg)
    launch_all()
    sub_k, sub_launch = mk.prepare_trace(scene, *sub, cfg)
    sub_ms = cuda_ms(sub_launch, 1)
    if not torch.equal(out()[idx], sub_k):
        raise AssertionError(f"{what}: the main-path launches and the "
                             "subset launch disagree at the same lanes")
    plain, want = host_ms(lambda: plain_trace(scene, *sub, cfg))
    err = float((sub_k - want).abs().max())
    image_gate(sub_k, want, f"{what} at {idx.numel()} of its bench lanes "
               f"(max lane error {err:.3e})")
    ms = cuda_ms(launch_all, 2) / n_launch
    n_cnt = mk.BVH_COUNTERS if mode == "bvh" else mk.COUNTERS
    cnt = torch.zeros((n, n_cnt), dtype=torch.int32, device=dev)
    _, counted = chunk_launches(mk, scene, lanes, sizes, cfg, counters=cnt)
    counted()
    if mode == "bvh":
        ops, _, work = k3_ops(cnt)
    else:
        ops, work = k1_ops(scene, cnt)
    bnd, by = bound(ops / n_launch, n / n_launch * (12 + 12 + 4 + 4 + 12))
    print(f"   {what}: {n} lanes in {n_launch} launch(es), work {work}, "
          f"{ops:.4e} ops; per launch {ms:.4f} ms, bound {bnd:.4f} ms "
          f"({by}); kernel on {idx.numel()} lanes {sub_ms:.3f} ms vs plain "
          f"{plain:.1f} ms", flush=True)
    out = dict(launches=n_launch, err=err, ms=ms, plain=plain, bound=bnd,
               by=by, plain_lanes=int(idx.numel()), ms_plain_lanes=sub_ms,
               lanes_per_frame=n)
    if mode == "loop":
        # K7 without its guard: the time, and the bound over the work the
        # unguarded soft loop does (the yardstick of the parent's K7)
        cnt.zero_()
        _, counted = chunk_launches(mk, scene, lanes, sizes, cfg,
                                    counters=cnt, soft_guard=False)
        counted()
        u_ops, u_work = k1_ops(scene, cnt)
        _, u_launch = chunk_launches(mk, scene, lanes, sizes, cfg,
                                     soft_guard=False)
        out["unguarded_ms"] = cuda_ms(u_launch, 2) / n_launch
        out["unguarded_bound"] = bound(u_ops / n_launch, n / n_launch * (
            12 + 12 + 4 + 4 + 12))[0]
        print(f"   {what}: unguarded work {u_work}, {u_ops:.4e} ops; per "
              f"launch {out['unguarded_ms']:.4f} ms, bound "
              f"{out['unguarded_bound']:.4f} ms", flush=True)
    if mode == "bvh":
        out["split"] = k3_split(mk, scene, lanes, sizes, cfg)
        out["walk_smem_bytes"] = 4 * mk.pack_walk_table(scene).numel()
        print(f"   {what}: K3+K4 ms a launch over its walk table "
              f"({out['walk_smem_bytes']} B) with soft shadows, hard only "
              f"and without lights: {out['split']}", flush=True)
    return out


def slice_rows(mk, scenes, frames, cfg, record):
    """The rows of K7 and K1-ext at the three bench frames of the slice
    (K1-ext's row is K1 on the textured frame; K3+K4 with vertex normals
    on the smooth frame rides along as extra keys)."""
    src = "raytrace_tpu_torch/csrc/"
    mkpy = "raytrace_tpu/ops/megakernel.py:"
    rows = []
    got = {}
    for key, kernel, subset in (("textured", "trace_unroll", K3_SUBSET),
                                ("smooth", "trace_bvh", SMOOTH_SUBSET),
                                ("ico2561", "trace_bvh", SMOOTH_SUBSET),
                                ("loop", "trace_loop", K3_SUBSET)):
        s, go, launches = frames[key]
        got[key] = frame_kernel(mk, s, cfg, go, f"{key} frame ({kernel})",
                                subset)
        if launches[kernel] != got[key]["launches"]:
            raise AssertionError(f"the {key} frame launched {kernel} "
                                 f"{launches[kernel]} times, not its chunk "
                                 f"count {got[key]['launches']}")
    t, sm, lp = got["textured"], got["smooth"], got["loop"]
    record["k3_frames"] = {k: got[k] for k in ("smooth", "ico2561")}
    # K2 at the textured and loop frames and on ring-2500 (loop mode)
    record["k2_frames"] = {}
    for key, s, go in (("textured", frames["textured"][0], False),
                       ("loop", frames["loop"][0], True),
                       (f"ring{LOOP_LDG_RING}", record["k2_ring"], True)):
        m = k2_numbers(mk, s, cfg, go)
        k2_line(f"K2 on the {key} frame", m)
        record["k2_frames"][key] = m
    record["k2_loop_ms"] = record["k2_frames"]["loop"]["ms"]
    common = dict(route="cuda", library_ms=None)
    rows.append(dict(
        name="K7 trace_loop", source=src + "trace_loop.cu",
        replaces=mkpy + "608", launches=lp["launches"],
        max_abs_err=max([lp["err"]] + record["k7_check_err"]),
        ms=lp["ms"], plain_ms=lp["plain"], bound_ms=lp["bound"],
        bound_by=lp["by"], plain_lanes=lp["plain_lanes"],
        ms_plain_lanes=lp["ms_plain_lanes"],
        lanes_per_frame=lp["lanes_per_frame"],
        k2_mask_ms=record["k2_loop_ms"],
        unguarded_ms=lp["unguarded_ms"],
        unguarded_bound_ms=lp["unguarded_bound"],
        smem_bytes=mk.trace_smem_bytes(frames["loop"][0]),
        check_64x48=record["k7_check"], **common))
    rows.append(dict(
        name="K1-ext bounce body (in K1, K3+K4, K7)",
        source=src + "bounce.cuh", replaces=mkpy + "1921",
        launches=t["launches"],
        max_abs_err=max([t["err"], sm["err"]] + record["k1ext_check_err"]),
        ms=t["ms"], plain_ms=t["plain"], bound_ms=t["bound"],
        bound_by=t["by"], plain_lanes=t["plain_lanes"],
        ms_plain_lanes=t["ms_plain_lanes"],
        lanes_per_frame=t["lanes_per_frame"],
        bvh_vn_ms=sm["ms"], bvh_vn_launches=sm["launches"],
        bvh_vn_bound_ms=sm["bound"], bvh_vn_plain_ms=sm["plain"],
        bvh_vn_plain_lanes=sm["plain_lanes"],
        bvh_vn_lanes_per_frame=sm["lanes_per_frame"], **common))
    return rows


def port_rows(mk, trace_mod, scene, ring, grid, cfg, launches,
              dof_frames, record):
    """The rows of K1-guard (at the bench frame's lanes, guarded and
    unguarded) and of the masks' DoF branch (K2-dof, K6-dof, K6-stream-dof
    at the bench, ring-1000 and grid-5833 frames, lens L=0.1, F=10: the
    Renderer's)."""
    import torch
    dev = torch.device("cuda")
    src = "raytrace_tpu_torch/csrc/"
    mkpy = "raytrace_tpu/ops/megakernel.py:"
    common = dict(route="cuda", library_ms=None)
    px, o, d, pix, samp, sizes = lanes_of(scene, W, H, SPP, cfg, chunks=True)
    lanes = (o, d, pix, samp)
    n, n_k1 = o.shape[0], len(sizes)
    out = {}
    for guard in (True, False):
        cnt = torch.zeros((n, mk.COUNTERS), dtype=torch.int32, device=dev)
        _, counted = chunk_launches(mk, scene, lanes, sizes, cfg,
                                    counters=cnt, soft_guard=guard)
        counted()
        ops, work = k1_ops(scene, cnt)
        res, launch = chunk_launches(mk, scene, lanes, sizes, cfg,
                                     soft_guard=guard)
        launch()
        ms = cuda_ms(launch, 5) / n_k1
        bnd, by = bound(ops / n_k1, n / n_k1 * (12 + 12 + 4 + 4 + 12))
        out[guard] = dict(res=res(), ms=ms, ops=ops, work=work, bound=bnd,
                          by=by)
    g, u = out[True], out[False]
    if not torch.equal(g["res"], u["res"]):
        raise AssertionError("K1-guard changed the bench frame's lanes")
    idx = torch.arange(0, n, max(1, n // K3_SUBSET), device=dev)
    sub = tuple(t[idx] for t in lanes)
    with plain_guarded():
        plain, want = host_ms(lambda: trace_mod.trace(scene, *sub, cfg))
    err = float((g["res"][idx] - want).abs().max())
    image_gate(g["res"][idx], want, f"K1-guard at {idx.numel()} of the "
               f"bench lanes vs the plain guarded version (max lane error "
               f"{err:.3e})")
    _, sub_launch = mk.prepare_trace(scene, *sub, cfg)
    sub_ms = cuda_ms(sub_launch, 1)
    gw = g["work"]
    print(f"   K1-guard at the bench lanes: work {gw} (unguarded "
          f"{u['work']}); {1.0 - gw[6] / max(gw[5], 1):.4f} of the (lane, "
          f"light, occluder) triples skipped; per launch {g['ms']:.4f} ms "
          f"guarded vs {u['ms']:.4f} ms unguarded; bound {g['bound']:.4f} ms "
          f"for the guarded work, {u['bound']:.4f} ms for the unguarded; "
          f"plain guarded on {idx.numel()} lanes {plain:.1f} ms", flush=True)
    if launches["trace_guard"] != launches["trace_unroll"]:
        raise AssertionError(f"the bench frame ran K1 without its guard: "
                             f"{launches}")
    rows = [dict(
        name="K1-guard soft-shadow guard (in K1)",
        source=src + "brute_force.cuh", replaces=mkpy + "1718",
        launches=launches["trace_guard"],
        max_abs_err=max([err] + record["guard_err"]), ms=g["ms"],
        plain_ms=plain, bound_ms=g["bound"], bound_by=g["by"],
        unguarded_ms=u["ms"], unguarded_bound_ms=u["bound"],
        plain_lanes=int(idx.numel()), ms_plain_lanes=sub_ms,
        lanes_per_frame=n, guards=gw[5], flagged=gw[6],
        undrawn_soft_rays=gw[7], **common)]
    del px, o, d, pix, samp, lanes, out, g, u
    dcfg = dof_cfg(trace_mod, DOF_LENSES[0], max_depth=DEPTH,
                   shadow_samples=SOFT)
    for name, s, key, kernel, line in (
            ("K2-dof pixel_mask", scene, "bench", "pixel_mask", "2636"),
            ("K6-dof pixel_mask_bvh", ring, "ring1000", "pixel_mask_bvh",
             "2774"),
            ("K6-stream-dof pixel_mask_stream", grid, "grid5833",
             "pixel_mask_stream", "2774")):
        if kernel != "pixel_mask":
            m = mask_numbers(mk, s, dcfg)
            mask_line(f"{name} (L={dcfg.dof_lens_radius}, "
                      f"F={dcfg.dof_focus_distance})", m)
            rows.append(dict(
                name=name, source=src + "pixel_mask.cu",
                replaces=mkpy + line, launches=dof_frames[key]["mask_dof"],
                max_abs_err=record["dof_mask_err"], ms=m["ms"],
                plain_ms=m["plain"], bound_ms=m["bound"], bound_by=m["by"],
                **mask_keys(m), **common))
            continue
        m = k2_numbers(mk, s, dcfg)
        k2_line(f"{name} (L={dcfg.dof_lens_radius}, "
                f"F={dcfg.dof_focus_distance})", m)
        rows.append(dict(
            name=name, source=src + "pixel_mask.cu", replaces=mkpy + line,
            launches=dof_frames[key]["mask_dof"],
            max_abs_err=record["dof_mask_err"], ms=m["ms"],
            plain_ms=m["plain"], bound_ms=m["bound"], bound_by=m["by"],
            **k2_keys(m), **common))
    return rows


def kernel_rows(mk, trace_mod, scene, ring, cfg, launches, launches_bvh,
                record):
    """Each kernel at its bench frame: checks, times, bounds; the rows of
    the JSON kernel record."""
    import torch
    dev = torch.device("cuda")
    n_px = W * H
    rows = []

    # K2 at the bench frame
    k2 = k2_numbers(mk, scene, cfg)

    # K1 at the bench lanes (100 spp over the hit pixels), per launch of
    # the main path's chunks
    px, o, d, pix, samp, sizes = lanes_of(scene, W, H, SPP, cfg, chunks=True)
    n_k1 = len(sizes)
    cnt = torch.zeros((o.shape[0], mk.COUNTERS), dtype=torch.int32,
                      device=dev)
    k1_out, k1_counted = chunk_launches(mk, scene, (o, d, pix, samp), sizes,
                                       cfg, counters=cnt)
    k1_counted()
    got = k1_out()
    _, k1_launch = chunk_launches(mk, scene, (o, d, pix, samp), sizes, cfg)
    k1_ms = cuda_ms(k1_launch, 5) / n_k1
    k1_plain, want = host_ms(lambda: trace_mod.trace(scene, o, d, pix, samp,
                                                     cfg))
    k1_err = float((got - want).abs().max())
    image_gate(pixel_image(px, got, W, H, SPP),
               pixel_image(px, want, W, H, SPP),
               f"K1 at the bench lanes (max lane error {k1_err:.3e})")
    ops, work = k1_ops(scene, cnt)
    k1_bound, k1_by = bound(ops / n_k1,
                            o.shape[0] / n_k1 * (12 + 12 + 4 + 4 + 12))
    print(f"   K1: {o.shape[0]} lanes in {n_k1} launch(es), work [closest, "
          f"hard, soft, sphere/plane tests, tri/box tests, guards, "
          f"flagged, undrawn soft rays] = {work}, "
          f"{ops:.4e} ops; per launch {k1_ms:.4f} ms, bound "
          f"{k1_bound:.4f} ms; plain over all lanes {k1_plain:.1f} ms",
          flush=True)
    k2_line(f"K2 ({n_px} pixels)", k2)
    del px, o, d, pix, samp, cnt, got, want

    # K6 (the pre-pass and the walk) at the bvh bench frame
    k6 = mask_numbers(mk, ring, cfg)
    mask_line(f"K6 ({n_px} pixels, {ring.accel.n_nodes} nodes)", k6)

    # K3+K4 at the bvh bench lanes, per launch of the main path's chunks
    px, o, d, pix, samp, sizes = lanes_of(ring, W, H, SPP, cfg, chunks=True)
    lanes = (o, d, pix, samp)
    n, n_k3 = o.shape[0], len(sizes)
    idx = torch.arange(0, n, max(1, n // K3_SUBSET), device=dev)
    so, sd, spix, ssamp = o[idx], d[idx], pix[idx], samp[idx]
    k3_out, k3_launch = chunk_launches(mk, ring, lanes, sizes, cfg)
    k3_launch()
    sub_k, sub_launch = mk.prepare_trace(ring, so, sd, spix, ssamp, cfg)
    sub_ms = cuda_ms(sub_launch, 1)
    if not torch.equal(k3_out()[idx], sub_k):
        raise AssertionError("K3: the main-path launches and the subset "
                             "launch disagree at the same lanes")
    plain_ms, want = host_ms(lambda: trace_mod.trace(
        ring, so, sd, spix, ssamp, cfg))
    k3_err = float((sub_k - want).abs().max())
    image_gate(sub_k, want, f"K3+K4 at {idx.numel()} of the bvh bench lanes "
               f"(one lane a pixel; max lane error {k3_err:.3e})")
    hard_cfg = trace_mod.TraceConfig(max_depth=DEPTH, shadow_samples=SOFT,
                                     seed=0, soft_shadows=False)
    plain_hard_ms, _ = host_ms(lambda: trace_mod.trace(
        ring, so, sd, spix, ssamp, hard_cfg))
    k3_ms = cuda_ms(k3_launch, 2) / n_k3
    _, hard_launch = chunk_launches(mk, ring, lanes, sizes, hard_cfg)
    hard_ms = cuda_ms(hard_launch, 2) / n_k3
    # K3-wide: the same launches on the binary walk, and the slab tests of
    # each walk
    ring_bin = without_wide(ring)
    _, bin_launch = chunk_launches(mk, ring_bin, lanes, sizes, cfg)
    bin_ms = cuda_ms(bin_launch, 2) / n_k3
    cnt = torch.zeros((n, mk.BVH_COUNTERS), dtype=torch.int32, device=dev)
    _, counted = chunk_launches(mk, ring_bin, lanes, sizes, cfg, counters=cnt)
    counted()
    work_bin = k3_ops(cnt)[2]
    cnt.zero_()
    _, counted = chunk_launches(mk, ring, lanes, sizes, cfg, counters=cnt)
    counted()
    ops, k4_ops, work = k3_ops(cnt)
    k3_bound, k3_by = bound(ops / n_k3, n / n_k3 * (12 + 12 + 4 + 4 + 12))
    k4_bound, k4_by = bound(k4_ops / n_k3, 0)
    split = k3_split(mk, ring, lanes, sizes, cfg)
    walk_bytes = 4 * mk.pack_walk_table(ring).numel()
    print(f"   K3+K4: ms a launch over its walk table ({walk_bytes} B) with "
          f"soft shadows, hard only and without lights: {split}",
          flush=True)
    print(f"   K3+K4: {n} lanes in {n_k3} launches, work [closest, hard, "
          f"soft, slab, sphere, triangle, fused slab, fused (ray, sphere), "
          f"fused (ray, triangle), plane/box] = {work}, {ops:.4e} ops of "
          f"which K4 {k4_ops:.4e}; per launch {k3_ms:.4f} ms, without soft "
          f"shadows {hard_ms:.4f} ms (K4 {k3_ms - hard_ms:.4f} ms); bound "
          f"per launch {k3_bound:.4f} ms (K4 {k4_bound:.4f} ms)", flush=True)
    print(f"   K3+K4 on {idx.numel()} lanes: {sub_ms:.3f} ms vs plain "
          f"{plain_ms:.1f} ms (plain without soft shadows "
          f"{plain_hard_ms:.1f} ms)", flush=True)
    print(f"   K3-wide: per launch {k3_ms:.4f} ms on the 4-wide walk vs "
          f"{bin_ms:.4f} ms on the binary walk; work on the binary walk "
          f"{work_bin}", flush=True)

    if (launches["trace_unroll"], launches_bvh["trace_bvh"]) != (n_k1, n_k3):
        raise AssertionError(f"the main path's trace launches "
                             f"{launches['trace_unroll']}, "
                             f"{launches_bvh['trace_bvh']} are not its "
                             f"chunk counts {n_k1}, {n_k3}")

    def row(name, source, replaces, n_launch, err, ms, plain, bnd, by,
            **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=n_launch, max_abs_err=err,
                    ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                    library_ms=None, **extra)

    src = "raytrace_tpu_torch/csrc/"
    mkpy = "raytrace_tpu/ops/megakernel.py:"
    subset = dict(plain_lanes=int(idx.numel()), ms_plain_lanes=sub_ms,
                  lanes_per_frame=n)
    rows += [
        row("K1 trace_unroll", src + "trace_unroll.cu", mkpy + "2987",
            launches["trace_unroll"], k1_err, k1_ms, k1_plain, k1_bound,
            k1_by),
        row("K2 pixel_mask", src + "pixel_mask.cu", mkpy + "2532",
            launches["pixel_mask"], record["k2_err"], k2["ms"], k2["plain"],
            k2["bound"], k2["by"], **k2_keys(k2)),
        row("K3 trace_bvh", src + "trace_bvh.cu", mkpy + "954",
            launches_bvh["trace_bvh"], max([k3_err] + record["k3walk_err"]),
            k3_ms, plain_ms, k3_bound, k3_by, split=split,
            walk_smem_bytes=walk_bytes, **subset),
        row("K4 trace_bvh soft walk", src + "bvh_walk.cuh", mkpy + "1308",
            launches_bvh["trace_bvh"], k3_err, k3_ms - hard_ms,
            plain_ms - plain_hard_ms, k4_bound, k4_by,
            **subset),
        row("K6 pixel_mask_bvh", src + "pixel_mask.cu", mkpy + "2661",
            launches_bvh["pixel_mask_bvh"], record["k6_err"], k6["ms"],
            k6["plain"], k6["bound"], k6["by"], **mask_keys(k6)),
        row("K6-table mask_table (pre-pass of K6, K6-stream past the "
            "shared-memory budget)", src + "pixel_mask.cu", mkpy + "2762",
            record["past_cap_table"]["launches"], 0.0,
            record["past_cap_table"]["ms"],
            record["past_cap_table"]["plain"],
            record["past_cap_table"]["bound"],
            record["past_cap_table"]["by"], entry="rt_mask_table_kernel",
            at="past_cap frame (32x24, a 274,626-primitive grid)",
            table_bytes=record["past_cap_table"]["table_bytes"]),
        row("K3-wide 4-wide stack walk (in K3+K4, K5)",
            src + "bvh_walk.cuh", mkpy + "1000", launches_bvh["trace_wide"],
            max([k3_err] + record["k3wide_err"]), k3_ms, plain_ms,
            k3_bound, k3_by, binary_ms=bin_ms, slab_tests=work[3],
            binary_slab_tests=work_bin[3], soft_slab_tests=work[6],
            binary_soft_slab_tests=work_bin[6], **subset),
    ]
    return rows


if __name__ == "__main__":
    sys.exit(main())
