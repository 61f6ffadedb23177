"""P1, the dependent-row copy probe, against the JAX probe on the CPU.

``raytrace_tpu_torch/tools/measure_dma_stream.py:chain_plain`` (the plain
version of ``csrc/dma_probe.cu``) must equal the TPU probe of
``tools/measure_dma_stream.py`` bit for bit: its kernel, built by the
tool's own ``make_kernel`` with the specs that its ``run()`` uses, runs in
Pallas interpret mode. (The tool's own oracle in ``run()`` sums in
float64 and so differs in the last bits; it is not used.) The card's
three variants are held to ``chain_plain`` in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytrace_tpu_torch.tools import measure_dma_stream as p1

TOOL = os.path.join(os.path.dirname(__file__), "..", "tools",
                    "measure_dma_stream.py")


@functools.lru_cache(maxsize=1)
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_dma_probe", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def jax_probe(n_steps, dst):
    """The TPU probe's pallas_call, as run() builds it, in interpret
    mode."""
    tool = jax_tool()
    scratch = (pltpu.SMEM((1, tool.ROW_F32), jnp.float32) if dst == "smem"
               else pltpu.VMEM((1, tool.ROW_F32), jnp.float32))
    return pl.pallas_call(
        tool.make_kernel(n_steps, dst),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1,), jnp.float32),
        scratch_shapes=[scratch, pltpu.SemaphoreType.DMA],
        interpret=True)


def bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def test_make_table_is_the_tools_table():
    tool = jax_tool()
    want = (np.arange(tool.N_ROWS * tool.ROW_F32, dtype=np.float32)
            .reshape(tool.N_ROWS, tool.ROW_F32) % 1000) * 1e-3
    got = p1.make_table()
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("seed", [0, 17, 8191])
@pytest.mark.parametrize("n_steps", [1, 50, 200])
@pytest.mark.parametrize("dst", ["smem", "vmem"])
def test_chain_plain_equals_jax_probe(dst, n_steps, seed):
    tab = p1.make_table()
    got = p1.chain_plain(tab, n_steps, seed)
    want = jax_probe(n_steps, dst)(jnp.asarray(tab.numpy()),
                                   jnp.array([seed], jnp.int32))
    assert got.shape == (1,) and got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def test_chain_wraps_int32_and_truncates_v0():
    """A table of values in (-3000, 3000): int32(v0) moves the index
    (truncated toward zero, negative too), and idx * 1664525 wraps in
    int32 from the first step (8191 * 1664525 > 2^31)."""
    assert 8191 * 1664525 > 2 ** 31
    rng = np.random.default_rng(9)
    tool = jax_tool()
    tab = rng.uniform(-3000.0, 3000.0,
                      (tool.N_ROWS, tool.ROW_F32)).astype(np.float32)
    got = p1.chain_plain(torch.from_numpy(tab), 60, 8191)
    want = jax_probe(60, "smem")(jnp.asarray(tab),
                                 jnp.array([8191], jnp.int32))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    # the same chain written out in Python integers
    idx, acc = 8191, np.float32(0.0)
    for _ in range(60):
        v0, v1 = tab[idx, 0], tab[idx, -1]
        acc = np.float32(np.float32(acc + v0) + v1)
        t = (idx * 1664525 + 1013904223 + int(v0)) & 0xFFFFFFFF
        t = t - (1 << 32) if t >= 1 << 31 else t
        idx = t % tool.N_ROWS
    assert bits(got.numpy())[0] == bits(acc)


def test_chain_on_the_cpu_runs_the_plain_version():
    tab = p1.make_table(64, 8)
    p1.reset_launches()
    for variant in p1.VARIANTS:
        got = p1.chain(tab, 30, seed=3, variant=variant)
        assert torch.equal(got, p1.chain_plain(tab, 30, seed=3))
    assert sum(p1.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        p1.chain(tab, 30, seed=64)
    with pytest.raises(ValueError):
        p1.chain(tab, 30, variant="dma")


def test_the_kernel_needs_the_card():
    """The kernel's wrapper refuses a CPU table; the tool's measurement
    asks for CUDA and raises without a card; its main exits non-zero."""
    with pytest.raises(RuntimeError, match="not CUDA"):
        p1.prepare_chain(p1.make_table(64, 8), 10)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        p1.measure(10)
    assert p1.main(["10"]) != 0
