"""The port's benchmark sweep, its command line and the optimisation demo
(raytrace_tpu_torch.bench), on the CPU at reduced sizes (32x24, 1 spp,
depth 2; the demo at 100 spheres, 256 rays, 32x24).

The sweep's results and report carry the JAX package's keys (and the
device the sweep ran on), its rays/s is pixels/s x samples, and the demo's
BVH walk gives the naive scan's hits.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from raytrace_tpu.bench import suite as jsuite
from raytrace_tpu_torch.bench import cli, optimization_demo
from raytrace_tpu_torch.bench import suite as tsuite
from test_torch_scene import one_torch_thread  # noqa: F401

SMALL = dict(width=32, height=24, samples_list=(1,), max_depth=2,
             repetitions=1, warmup=0)


def test_benchmark_suite_runs():
    suite = tsuite.BenchmarkSuite(tsuite.BenchmarkConfig(**SMALL),
                                  device="cpu")
    (res,) = suite.run(progress=False)
    assert res.min_s > 0 and res.samples == 1
    np.testing.assert_allclose(res.rays_per_second,
                               32 * 24 / res.min_s * res.samples)
    assert set(res.to_dict()) == {f.name for f in dataclasses.fields(
        jsuite.BenchmarkResult)}
    rep = suite.report_dict()
    assert rep["device"] == "cpu" and len(rep["results"]) == 1
    assert set(rep["config"]) == {f.name for f in dataclasses.fields(
        jsuite.BenchmarkConfig)}


def test_quick_and_memory_benchmark():
    res = tsuite.quick_benchmark(16, 12, 1, device="cpu")
    assert len(res.times_seconds) == 2 and res.rays_per_second > 0
    mem = tsuite.memory_benchmark(200, device="cpu")
    assert mem["spheres"] == 200 and mem["bvh_nodes"] > 1
    assert mem["bvh_build_seconds"] >= 0.0


def test_suite_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        tsuite.BenchmarkSuite()


def test_cli_writes_the_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert cli.main(["--device", "cpu", "--width", "32", "--height", "24",
                     "--samples", "1", "--max-depth", "2",
                     "--repetitions", "1", "--warmup", "0",
                     "--output", str(out), "--metrics"]) == 0
    rep = json.loads(out.read_text())
    assert rep["config"]["samples_list"] == [1]
    assert rep["results"][0]["rays_per_second"] > 0
    text = capsys.readouterr().out
    assert "report saved to" in text and "host_memory_bytes" in text


def test_optimization_demo_main(capsys):
    assert optimization_demo.main(["--device", "cpu", "--spheres", "100",
                                   "--rays", "256", "--width", "32",
                                   "--height", "24"]) == 0
    text = capsys.readouterr().out
    for part in ("=== fast math ===", "naive closest-hit", "Octree:",
                 "KD-tree:", "bvh_build_time"):
        assert part in text
    got = optimization_demo.demo_spatial(100, 256, device="cpu")
    assert got["bvh_nodes"] > 1 and got["bvh_seconds"] > 0
