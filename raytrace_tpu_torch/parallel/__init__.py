"""Parallelism subsystems of the port: for now the elastic
sample-accumulator checkpoint/resume and the graceful-shutdown helpers.

The mesh, the sharded renders and the multi-host orchestration of
``raytrace_tpu/parallel/`` are not ported yet (ROADMAP Queue 1 item 7).
"""

from .checkpoint import (Accumulator, ContextShutdown, GracefulShutdown,
                         ResourceManager, SignalHandler,
                         render_with_checkpoints)

__all__ = [
    "Accumulator", "GracefulShutdown", "render_with_checkpoints",
    "ResourceManager", "ContextShutdown", "SignalHandler",
]
