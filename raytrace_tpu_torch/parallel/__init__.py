"""Parallelism of the port: the (px, sp) mesh, the sharded renders, the
multi-process orchestration over ``torch.distributed``, and the elastic
sample-accumulator checkpoint/resume.

The reference's four parallelism layers map as in the JAX package
(``raytrace_tpu/parallel/``): the tile pool -> pixel sharding over
``px``; work stealing -> a static partition; the staged pipeline -> the
wavefront of the trace kernels; the HTTP distribution ->
``torch.distributed`` collectives.
"""

from .mesh import Mesh, make_mesh, single_device_mesh
from .shard import (render_band_sharded, render_linear_sharded,
                    render_wavefront_sharded)
from .checkpoint import (Accumulator, ContextShutdown, GracefulShutdown,
                         ResourceManager, SignalHandler,
                         render_with_checkpoints)
from .distributed import (DistributedRenderer, NodeStatus, heartbeat,
                          initialize, rerender_missing_rows, shutdown)

__all__ = [
    "Mesh", "make_mesh", "single_device_mesh",
    "render_band_sharded", "render_linear_sharded",
    "render_wavefront_sharded",
    "Accumulator", "GracefulShutdown", "render_with_checkpoints",
    "ResourceManager", "ContextShutdown", "SignalHandler",
    "DistributedRenderer", "NodeStatus", "heartbeat", "initialize",
    "rerender_missing_rows", "shutdown",
]
