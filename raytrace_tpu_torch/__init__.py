"""raytrace_tpu_torch: the path tracer on PyTorch and CUDA for Hopper.

A port of ``raytrace_tpu`` (JAX on a TPU), which stays in the repository
as the reference. The main path renders a scene JSON to a PNG through
hand-written CUDA kernels (``csrc/``), by the scene's kernel mode:

* up to 96 primitives (48 with vertex normals): the per-pixel
  conservative hit mask K2 and the bounce megakernel K1;
* 97-4096 primitives with a scene BVH: the mask's tree walk K6 and the
  bounce megakernel's tree walks K3+K4 over a walk table in shared
  memory;
* past 4096 primitives with a scene BVH, the stream tier: the node-only
  mask walk K6-stream and the stream megakernel K5 over the leaf rows in
  global memory, run as a split ladder of resumable launches (K1-state).
  Past the JAX package's 262,144-primitive cap, where its Renderer takes
  a banded jnp engine, the port stays on this route (the past-cap route),
  up to the 2^24 primitives that the stream node table can index;
* past the unroll limit without a BVH (loop mode): K2 and the
  brute-force megakernel K7, its tables in shared memory up to 227 KB.

K1 and K7 run one brute-force policy, with the soft-shadow guard K1-guard
(occluders that cannot block a light's jitter cone skip its soft rays, in
chunks of 96 for any occluder count); K1, K3+K4 and K7 run persistent
blocks over a lane counter. The megakernels share one bounce body with
smooth normals, the extended material kinds and procedural textures
(K1-ext). Each kernel has a plain PyTorch version beside it, which the
CPU path and the tests use. Entry points run on the GPU unless the caller
passes ``device="cpu"``.

The production loop is ported too: adaptive sampling over the same trace
kernels (``render_adaptive``, host or device accumulation, with
checkpoint/resume), the AOV feature buffers (``render_aovs``), the
feature-guided denoiser (``denoise``) and the sample-accumulator
checkpoints of ``parallel``. So is the differentiable path (``diff``):
reverse-mode gradients of a rendered image through the eager engine,
checkpointed a bounce at a time, and inverse rendering.
"""

from . import diff
from .adaptive import render_adaptive
from .aov import render_aovs
from .denoising import denoise
from .renderer import BenchmarkData, Renderer, render_band, render_wavefront
from .scene import Scene
from .scene import from_dict as scene_from_dict
from .scene import load as load_scene
from .trace import TraceConfig
from .trace import trace as trace_rays

__all__ = ["BenchmarkData", "Renderer", "Scene", "TraceConfig", "denoise",
           "diff", "load_scene", "render_adaptive", "render_aovs",
           "render_band", "render_wavefront", "scene_from_dict",
           "trace_rays"]
