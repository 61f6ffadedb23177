"""Real multi-process runs of the port (raytrace_tpu_torch/parallel/
distributed.py) on the CPU, the counterpart of
tests/test_distributed_multiproc.py.

* A 2-process gloo group of the port's worker
  (``python -m raytrace_tpu_torch.tools.dist_worker --device cpu``):
  ``initialize`` with an explicit coordinator, ``NodeStatus`` with
  process_count 2, ``heartbeat`` (a cross-process ``all_reduce``),
  ``DistributedRenderer.render_linear`` over the group's px mesh (one
  coordinate a process, assembled by the ``all_reduce``), one sharded
  train step (the differentiable ``all_reduce`` of the image, then the
  gradients summed over the processes) and ``render_wavefront_sharded``.
  The parent holds the gathered image to the port's single-process
  ``render_band`` (atol 1e-6) and to the JAX package's (atol 1e-5), the
  wavefront to the single-process ``render_wavefront`` (atol 1e-6), and
  the train step's loss and light intensity to the single-process step
  (rtol 1e-5).
* A worker that dies mid-render (``tools/elastic_worker.py``'s port):
  the survivor renders the lost rows again; the recovered frame equals
  the port's uninterrupted ``render_band`` bit for bit and the JAX
  package's within 1e-5.
* ``initialize`` is a no-op without a coordinator or torchrun's
  environment.

Every ``communicate()`` is capped at 120 s.
"""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as rt
from raytrace_tpu import renderer as jrenderer
from raytrace_tpu import trace as jtrace
from raytrace_tpu_torch import renderer as trender
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.parallel import distributed as tdist
from raytrace_tpu_torch.tools import dist_worker, elastic_worker
from test_torch_scene import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP = 32, 24, 2
WAVE_SPP, WAVE_DEPTH = 2, 3
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _finish(procs, what):
    """Wait for every process (each capped at TIMEOUT s); returns their
    outputs, killing all of them on a timeout."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"{what} timed out")
        outs.append(out.decode(errors="replace"))
    return outs


def _module(name):
    return [sys.executable, "-m", f"raytrace_tpu_torch.tools.{name}"]


def test_two_process_cluster_renders(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    out_npz = str(tmp_path / "proc0.npz")
    procs = [subprocess.Popen(
        _module("dist_worker") + [coord, "2", str(i), out_npz, "--device",
                                  "cpu", "--size", f"{W}x{H}", "--spp",
                                  str(SPP), "--depth", "3", "--wavefront",
                                  f"{W}x{H},{WAVE_SPP},{WAVE_DEPTH}"],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(2)]
    outs = _finish(procs, "the distributed workers")
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i]}"

    z = np.load(out_npz)
    assert int(z["process_count"]) == 2 and int(z["global_devices"]) == 2
    assert str(z["platform"]) == "cpu"
    np.testing.assert_array_equal(z["hb"], np.ones(2, np.float32))
    stats = json.loads(str(z["stats"]))
    assert stats["total_nodes"] == 2 and stats["devices"] == 2
    assert stats["completed_jobs"] == 1

    ts = tscene.from_dict(dist_worker.SCENE_DICT, device="cpu")[0]
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=2)
    ref = trender.render_band(ts, 0, width=W, height=H, band_h=H,
                              samples=SPP, cfg=cfg).numpy()
    np.testing.assert_allclose(z["img"], ref, atol=1e-6, rtol=0)
    js = rt.scene_from_dict(dist_worker.SCENE_DICT)[0]
    jref = np.asarray(jrenderer.render_band(
        js, jnp.int32(0), width=W, height=H, band_h=H, samples=SPP,
        cfg=jtrace.TraceConfig(max_depth=3, shadow_samples=2)))
    np.testing.assert_allclose(z["img"], jref, atol=1e-5, rtol=0)

    wcfg = ttrace.TraceConfig(max_depth=WAVE_DEPTH, shadow_samples=16)
    wref = trender.render_wavefront(ts, width=W, height=H, samples=WAVE_SPP,
                                    cfg=wcfg).numpy()
    assert int(z["overflow"]) == 0
    np.testing.assert_allclose(z["wavefront"], wref, atol=1e-6, rtol=0)

    loss, intensity = dist_worker.train_step(ts, width=W, height=H,
                                             samples=SPP, cfg=cfg)
    np.testing.assert_allclose(z["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(z["intensity"], intensity, rtol=1e-5)
    assert not np.array_equal(intensity, ts.lights.intensity.numpy())


def test_worker_death_recovery(tmp_path):
    """The victim dies after two chunks of its band; the survivor sees its
    heartbeat go stale, renders the missing rows again and splices them:
    the recovered frame is the uninterrupted render."""
    half = elastic_worker.H // 2

    def start(role, y0, rows):
        return subprocess.Popen(
            _module("elastic_worker") + [role, str(y0), str(rows),
                                         str(tmp_path), "--device", "cpu"],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)

    survivor = start("survivor", 0, half)
    victim = start("victim", half, elastic_worker.H - half)
    vout, sout = _finish([victim, survivor], "the elastic workers")
    assert victim.returncode == 3, f"the victim did not die:\n{vout}"
    assert survivor.returncode == 0, f"the survivor failed:\n{sout}"

    z = np.load(tmp_path / "recovered.npz")
    rows_done = int(z["victim_rows_done"])
    assert 0 < rows_done < elastic_worker.H - half
    assert len(z["missing"]) == elastic_worker.H - half - rows_done

    ts = tscene.from_dict(dist_worker.SCENE_DICT, device="cpu")[0]
    ref = trender.render_band(ts, 0, width=elastic_worker.W,
                              height=elastic_worker.H,
                              band_h=elastic_worker.H,
                              samples=elastic_worker.SPP,
                              cfg=elastic_worker.CFG).numpy()
    np.testing.assert_array_equal(z["img"], ref)
    js = rt.scene_from_dict(dist_worker.SCENE_DICT)[0]
    jref = np.asarray(jrenderer.render_band(
        js, jnp.int32(0), width=elastic_worker.W, height=elastic_worker.H,
        band_h=elastic_worker.H, samples=elastic_worker.SPP,
        cfg=jtrace.TraceConfig(max_depth=3, shadow_samples=2)))
    np.testing.assert_allclose(z["img"], jref, atol=1e-5, rtol=0)


def test_initialize_without_a_cluster_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.initialize() is None
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        tdist.initialize("127.0.0.1:1")
