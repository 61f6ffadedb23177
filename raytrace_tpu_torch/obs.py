"""Observability: metrics, progress reporting, alerts, profiling (port of
``raytrace_tpu/obs.py``).

* ``RenderMetrics``/``MetricsCollector``: ray and pixel accounting that
  the Renderer feeds (``Renderer.metrics``), host memory from the process
  and device memory from ``torch.cuda`` (the reference's metrics.go).
* ``ProgressReporter``: the ``[====>   ] 52.3% | rays/s | ETA`` bar.
* ``PerformanceMonitor``: threshold alerts to observer callbacks.
* ``Profiler``: ``torch.profiler`` traces (CPU and CUDA activities) written
  to ``out_dir`` as a Chrome trace, ``record_function`` ranges, memory
  stats, and a live stats endpoint: PyTorch has no profiling server, so
  ``start_server`` serves ``get_stats()`` as JSON over a stdlib HTTP
  server on a thread (the reference's PProfServer was an HTTP endpoint,
  profiler.go:195-228).
"""

from __future__ import annotations

import dataclasses
import http.server
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List

import torch


@dataclasses.dataclass
class RenderMetrics:
    """Parity with the RenderMetrics struct (metrics.go:12-41)."""

    rays_traced: int = 0
    pixels_completed: int = 0
    total_pixels: int = 0
    rays_per_second: float = 0.0
    pixels_per_second: float = 0.0
    elapsed_seconds: float = 0.0
    progress: float = 0.0
    eta_seconds: float = 0.0
    jobs_completed: int = 0
    device_memory_bytes: int = 0
    host_memory_bytes: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class MetricsCollector:
    """Thread-safe render metrics (metrics.go:72-224). Rates are computed
    when read; observers are called on every record."""

    def __init__(self):
        self._lock = threading.Lock()
        self._m = RenderMetrics()
        self._start = time.perf_counter()
        self._observers: List[Callable[[RenderMetrics], None]] = []

    def start(self, total_pixels: int) -> None:
        with self._lock:
            self._m = RenderMetrics(total_pixels=total_pixels)
            self._start = time.perf_counter()

    def record_rays(self, n: int) -> None:
        with self._lock:
            self._m.rays_traced += int(n)
        self._notify()

    def record_pixels(self, n: int) -> None:
        with self._lock:
            self._m.pixels_completed += int(n)
        self._notify()

    def record_job_complete(self) -> None:
        with self._lock:
            self._m.jobs_completed += 1
        self._notify()

    def add_observer(self, fn: Callable[[RenderMetrics], None]) -> None:
        self._observers.append(fn)

    def snapshot(self) -> RenderMetrics:
        with self._lock:
            m = dataclasses.replace(self._m)
        m.elapsed_seconds = time.perf_counter() - self._start
        if m.elapsed_seconds > 0:
            m.rays_per_second = m.rays_traced / m.elapsed_seconds
            m.pixels_per_second = m.pixels_completed / m.elapsed_seconds
        if m.total_pixels:
            m.progress = m.pixels_completed / m.total_pixels
            if m.pixels_per_second > 0:
                m.eta_seconds = ((m.total_pixels - m.pixels_completed)
                                 / m.pixels_per_second)
        m.device_memory_bytes = device_memory_in_use()
        m.host_memory_bytes = host_memory_in_use()
        return m

    def _notify(self) -> None:
        if self._observers:
            snap = self.snapshot()
            for fn in self._observers:
                fn(snap)


def device_memory_in_use() -> int:
    """Bytes of tensors allocated on every CUDA device
    (``torch.cuda.memory_allocated``); 0 without CUDA."""
    if not torch.cuda.is_available():
        return 0
    return sum(torch.cuda.memory_allocated(i)
               for i in range(torch.cuda.device_count()))


def host_memory_in_use() -> int:
    """Peak resident memory of the process (the MemStats.HeapAlloc
    analog)."""
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (ImportError, OSError):
        return 0


class ProgressReporter:
    """[=====>    ] 52.3% | 1.2M rays/s | ETA 3.2s  (metrics.go:226-317)."""

    def __init__(self, collector: MetricsCollector, width: int = 40,
                 stream=None, min_interval: float = 0.1):
        self.collector = collector
        self.width = width
        self.stream = stream or sys.stderr
        self.min_interval = min_interval
        self._last = 0.0

    def report(self, force: bool = False) -> None:
        now = time.perf_counter()
        if not force and now - self._last < self.min_interval:
            return
        self._last = now
        m = self.collector.snapshot()
        filled = int(self.width * m.progress)
        bar = ("=" * max(0, filled - 1)
               + (">" if 0 < filled < self.width else "=" * (filled > 0))
               + " " * (self.width - filled))
        self.stream.write(
            f"\r[{bar}] {m.progress * 100:5.1f}% | "
            f"{m.rays_per_second / 1e6:6.2f}M rays/s | "
            f"ETA {m.eta_seconds:5.1f}s")
        self.stream.flush()

    def finish(self) -> None:
        self.report(force=True)
        self.stream.write("\n")
        self.stream.flush()


@dataclasses.dataclass
class Alert:
    name: str
    message: str
    value: float
    threshold: float
    timestamp: float


class PerformanceMonitor:
    """Threshold alerts (metrics.go:319-412): device memory above
    ``max_memory_bytes``, rays/s below ``min_rays_per_second`` once tracing
    has run for a second."""

    def __init__(self, collector: MetricsCollector,
                 max_memory_bytes: int = 100 * 1024 * 1024,
                 min_rays_per_second: float = 1000.0):
        self.collector = collector
        self.max_memory_bytes = max_memory_bytes
        self.min_rays_per_second = min_rays_per_second
        self.alerts: List[Alert] = []
        self._handlers: List[Callable[[Alert], None]] = []

    def add_handler(self, fn: Callable[[Alert], None]) -> None:
        self._handlers.append(fn)

    def check(self) -> List[Alert]:
        m = self.collector.snapshot()
        new: List[Alert] = []
        if m.device_memory_bytes > self.max_memory_bytes:
            new.append(Alert("memory", "device memory above threshold",
                             m.device_memory_bytes, self.max_memory_bytes,
                             time.time()))
        if (m.rays_traced > 0 and m.elapsed_seconds > 1.0
                and m.rays_per_second < self.min_rays_per_second):
            new.append(Alert("throughput", "rays/s below threshold",
                             m.rays_per_second, self.min_rays_per_second,
                             time.time()))
        self.alerts.extend(new)
        for a in new:
            for fn in self._handlers:
                fn(a)
        return new


class Profiler:
    """``torch.profiler`` wrapper (the working form of profiler.go:43-159).

    ``start``/``stop`` record a trace of CPU and (with a GPU) CUDA
    activity and write it to ``out_dir`` as a Chrome trace (the path is
    ``trace_path``); ``annotate`` names a region (``record_function``);
    ``start_server`` serves ``get_stats()`` as JSON on
    ``http://127.0.0.1:<port>/``."""

    def __init__(self, out_dir: str = "./profiles"):
        self.out_dir = out_dir
        self.active = False
        self.trace_path = None
        self._prof = None
        self._server = None
        self._thread = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        self._prof.stop()
        self.active = False
        os.makedirs(self.out_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.out_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json")
        self._prof.export_chrome_trace(self.trace_path)

    def annotate(self, name: str):
        """Context manager naming a trace region."""
        return torch.profiler.record_function(name)

    def start_server(self, port: int = 6060) -> None:
        profiler = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = json.dumps(profiler.get_stats()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                                       Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop_server(self) -> None:
        """Stop serving and close the socket, which frees the port."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join()
            self._server = self._thread = None

    def get_stats(self) -> Dict:
        """Memory stats (the MemStats dump, profiler.go:161-193): host and
        device bytes in use, and ``torch.cuda.memory_stats`` per device."""
        stats: Dict = {"host_memory_bytes": host_memory_in_use(),
                       "device_memory_bytes": device_memory_in_use()}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                stats[f"device_{i}"] = {
                    k: v for k, v in torch.cuda.memory_stats(i).items()
                    if isinstance(v, (int, float))}
        return stats

    def save_stats(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.get_stats(), f, indent=2)
