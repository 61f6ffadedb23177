"""obs.py and the Renderer's observability and engine switch, on the CPU.

* The obs cases of tests/test_components.py on the port: the metrics
  collector and the progress bar, the memory alert, the profiler's stats,
  and the stats server, which must free its port when it stops (here the
  port is bound again to show it); the profiler writes a Chrome trace.
* The Renderer's engines: "kernels" (the compacted wavefront) and "eager"
  (render_band in row bands, a ragged last one) agree within the goldens
  gate, and each meets the JAX package's jnp engine there; "kernels"
  raises on a scene that no kernel mode of the JAX package takes, where
  "auto" renders it; an unknown engine raises.
* progress_callback is called after each band and ends at (H, H);
  metrics count H*W pixels, H*W*spp camera rays and one job on both
  engines; pick_band_height is the JAX package's.
"""

import http.client
import io
import json
import os
import socket

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu import renderer as jrender
from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu_torch import obs
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch.bench.suite import ring_scene_dict
from raytrace_tpu_torch.ops import megakernel as tmk
from test_torch_renderer import asset_dict, gate
from test_torch_scene import one_torch_thread  # noqa: F401

W, H, S = 32, 24, 2


def test_metrics_collector_and_progress():
    c = obs.MetricsCollector()
    c.start(total_pixels=100)
    c.record_pixels(50)
    c.record_rays(5000)
    m = c.snapshot()
    assert m.progress == pytest.approx(0.5)
    assert m.rays_traced == 5000
    assert m.pixels_per_second > 0
    assert m.device_memory_bytes == obs.device_memory_in_use() == 0
    seen = []
    c.add_observer(seen.append)
    c.record_job_complete()
    assert seen and seen[-1].jobs_completed == 1
    buf = io.StringIO()
    rep = obs.ProgressReporter(c, stream=buf)
    rep.report(force=True)
    rep.finish()
    assert "%" in buf.getvalue() and "rays/s" in buf.getvalue()


def test_performance_monitor_alerts():
    c = obs.MetricsCollector()
    c.start(total_pixels=10)
    mon = obs.PerformanceMonitor(c, max_memory_bytes=-1)  # always alert
    seen = []
    mon.add_handler(seen.append)
    alerts = mon.check()
    assert alerts and alerts[0].name == "memory"
    assert seen == alerts


def test_profiler_stats_and_trace(tmp_path):
    p = obs.Profiler(out_dir=str(tmp_path))
    stats = p.get_stats()
    assert "host_memory_bytes" in stats and "device_memory_bytes" in stats
    p.save_stats(str(tmp_path / "stats.json"))
    assert json.load(open(tmp_path / "stats.json")).keys() == stats.keys()
    p.start()
    with p.annotate("a_region"):
        torch.ones(64).sum()
    p.stop()
    assert not p.active and os.path.exists(p.trace_path)
    assert "a_region" in open(p.trace_path).read()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_profiler_server_start_stop():
    """start_server serves get_stats() as JSON on 127.0.0.1; stop_server
    shuts it down and frees the port."""
    port = free_port()
    p = obs.Profiler()
    p.start_server(port=port)
    assert p._server is not None
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", "/")
    body = json.loads(conn.getresponse().read())
    conn.close()
    assert "host_memory_bytes" in body
    p.stop_server()
    assert p._server is None
    # the port is free again: a listener binds it (SO_REUSEADDR passes the
    # closed connection's TIME_WAIT, never a live listener), and so does
    # a second server
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        s.listen()
    p.start_server(port=port)
    p.stop_server()


def bench_scene():
    return tscene.from_dict(asset_dict("sphere_reflections_light"),
                            device="cpu")[0]


def run(engine, scene, band_h=None):
    r = trender.Renderer(device="cpu")
    r.set_samples(S)
    r.set_max_depth(4)
    r.engine = engine
    r.metrics = obs.MetricsCollector()
    progress = []
    r.progress_callback = lambda done, total: progress.append((done, total))
    img = r.render_linear(scene, W, H, band_h=band_h)
    return img, progress, r.metrics.snapshot(), r


@pytest.mark.parametrize("engine,band_h", [("auto", None),
                                           ("kernels", None),
                                           ("eager", None), ("eager", 10)])
def test_progress_and_metrics_count_the_frame(engine, band_h):
    img, progress, m, _ = run(engine, bench_scene(), band_h)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert progress[-1] == (H, H)
    assert [d for d, _ in progress] == sorted(d for d, _ in progress)
    if band_h:
        assert [d for d, _ in progress] == [10, 20, 24]
    assert m.pixels_completed == W * H and m.total_pixels == W * H
    assert m.rays_traced == W * H * S and m.jobs_completed == 1
    assert m.progress == pytest.approx(1.0)


def test_engines_agree_and_meet_the_jax_engine():
    s = bench_scene()
    kernels, _, _, r = run("kernels", s)
    eager, _, _, _ = run("eager", s)
    ragged, _, _, _ = run("eager", s, band_h=10)
    gate(kernels, eager)
    assert np.array_equal(ragged, eager)
    js = jscene.from_dict(asset_dict("sphere_reflections_light"))[0]
    want = np.asarray(jrender.render_band(
        js, jnp.int32(0), width=W, height=H, band_h=H, samples=S,
        cfg=jtrace.TraceConfig(max_depth=4)))
    gate(kernels, want)
    gate(eager, want)
    img = r.render(s, W, H)
    assert img.shape == (H, W, 3) and img.dtype == np.uint8


def test_kernels_engine_raises_where_no_kernel_fits(monkeypatch):
    """Past the JAX package's stream cap (lowered here below a small
    scene forced into stream mode) engine "kernels" raises, with no quiet
    fallback, where "auto" renders the scene in stream mode."""
    monkeypatch.setattr(tmk, "UNROLL_PRIM_LIMIT", 4)
    monkeypatch.setattr(tmk, "MAX_BVH_KERNEL_PRIMS", 8)
    monkeypatch.setattr(tmk, "MAX_STREAM_KERNEL_PRIMS", 8)
    s = tscene.with_accel(tscene.from_dict(ring_scene_dict(12),
                                           device="cpu",
                                           build_accel=False)[0],
                          leaf_size=4)
    assert not tmk.scene_fits_kernel(s)
    with pytest.raises(ValueError, match="scene_fits_kernel"):
        run("kernels", s)
    img, progress, m, _ = run("auto", s)
    assert progress == [(H, H)] and m.jobs_completed == 1
    with pytest.raises(ValueError, match="engine"):
        run("pallas", s)


def test_pick_band_height_is_the_jax_packages():
    for args in [(800, 600, 100), (32, 24, 2), (1920, 1080, 1),
                 (64, 48, 4)]:
        for n in (1, 100, 129, 5000, 300000):
            assert trender.pick_band_height(*args, n_prims=n) == (
                jrender.pick_band_height(*args, n_prims=n))
    s = bench_scene()
    js = jscene.from_dict(asset_dict("sphere_reflections_light"))[0]
    assert s.prim_count == jrender.scene_prim_count(js)
