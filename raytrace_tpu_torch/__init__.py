"""raytrace_tpu_torch: the path tracer on PyTorch and CUDA for Hopper.

A port of ``raytrace_tpu`` (JAX on a TPU), which stays in the repository
as the reference. The main path renders a scene JSON to a PNG through
hand-written CUDA kernels (``csrc/``): for scenes of up to 96 primitives
(48 with vertex normals) the per-pixel conservative hit mask K2 and the
bounce megakernel K1; for 97-4096 primitives with a scene BVH the mask's
tree walk K6 and the bounce megakernel's tree walks K3+K4; past the
unroll limit without a BVH, K2 and the brute-force megakernel K7. The
three megakernels share one bounce body with smooth normals, the
extended material kinds and procedural textures (K1-ext). Each kernel has
a plain PyTorch version beside it, which the CPU path and the tests use.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from .renderer import BenchmarkData, Renderer, render_wavefront
from .scene import from_dict as scene_from_dict
from .scene import load as load_scene
from .trace import TraceConfig

__all__ = ["BenchmarkData", "Renderer", "TraceConfig", "load_scene",
           "render_wavefront", "scene_from_dict"]
