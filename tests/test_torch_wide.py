"""The port's 4-wide walk (K3-wide) against the JAX package, on the CPU.

* The layout: bvh.widen4 gives the JAX package's
  pack_bvh4_tables(widen4(tree)) (transposed to one row per wide node)
  and its stack bound, bit for bit, on random trees, a tree whose root is
  a leaf, the empty tree and the trees that from_dict builds.
* The choice: bvh.wide_walk takes the 4-wide walk in bvh mode and in
  stream mode within the JAX kernel's budget, and the binary walk past
  it; trace_tables hands the kernels the 4-wide table exactly when it
  does.
* The walk: traverse_closest_wide gives traverse_closest's hits on
  scenes without exact ties, over the scene tables and over the stream
  rows.
* The order: on twin_scene_dict, whose clusters of coincident spheres tie
  exactly in t, the port's engine equals the JAX kernel
  (trace_pallas(..., interpret=True), which walks 4-wide) within 1e-5 on
  every lane, while the JAX jnp engine (binary walk) shows other copies
  on some lanes; with the 4-wide view taken away the port equals the jnp
  engine instead. One interpret call.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu import bvh as jbvh
from raytrace_tpu import scene as jscene
from raytrace_tpu import trace as jtrace
from raytrace_tpu.ops import megakernel as jmk
from raytrace_tpu_torch import bvh as tbvh
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch import trace as ttrace
from raytrace_tpu_torch.bench import suite
from raytrace_tpu_torch.ops import megakernel as tmk
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_split import as_torch
from test_torch_stream import (both_leaf4, forced, random_rays,  # noqa: F401
                               spheres_cube_plane_dict)
from test_torch_trace import camera_lanes


def jax_table(wide4):
    return np.asarray(jmk.pack_bvh4_tables(wide4)).T


def random_boxes(n, seed):
    r = np.random.default_rng(seed)
    c = r.uniform(-10, 10, (n, 3)).astype(np.float32)
    rad = r.uniform(0.2, 0.8, n).astype(np.float32)
    return c - rad[:, None], c + rad[:, None]


@pytest.mark.parametrize("n,leaf", [(203, 4), (5000, 32), (3, 4), (0, 4)])
def test_widen4_matches_jax(n, leaf):
    lo, hi = random_boxes(n, n)
    jw = jbvh.widen4(jbvh.build_bvh(lo, hi, leaf_size=leaf))
    table, stack = tbvh.widen4(tbvh.build_bvh(lo, hi, leaf_size=leaf))
    np.testing.assert_array_equal(table, jax_table(jw))
    assert stack == jw.max_stack


@pytest.mark.parametrize("name", ["ring1000", "mixed"])
def test_scene_wide4_matches_jax(name):
    d = suite.bvh_scene_dict(name)
    js = jscene.from_dict(d)[0]
    ts = tscene.from_dict(d, device="cpu")[0]
    assert ts.accel.wide4.dtype == torch.float32
    np.testing.assert_array_equal(ts.accel.wide4.numpy(),
                                  jax_table(js.accel.wide4))
    assert ts.accel.wide_stack == js.accel.wide4.max_stack
    assert tbvh.wide_walk(ts.accel)
    flat, dims, _ = tmk.trace_tables(ts, "bvh")
    assert dims[12] == ts.accel.wide4.shape[0]


def test_wide_walk_choice_in_stream_mode():
    """Stream mode keeps the 4-wide walk while 4 * (node floats + 4-wide
    floats + 128 * leaf size) fits 700,000 bytes (the JAX kernel's gate);
    leaf size 1 on grid-5833 is past it."""
    d = suite.grid_scene_dict()
    ts = tscene.from_dict(d, device="cpu")[0]
    assert tmk._kernel_mode(ts) == "stream" and tbvh.wide_walk(ts.accel)
    one = tscene.with_accel(tscene.from_dict(d, device="cpu",
                                             build_accel=False)[0],
                            leaf_size=1)
    acc = one.accel
    assert acc.stream_tab is not None and acc.wide4 is not None
    budget = 4 * (9 * acc.n_nodes + 36 * acc.wide4.shape[0]
                  + jmk.STREAM_ROW * acc.leaf_size)
    assert budget > 700_000 and not tbvh.wide_walk(acc)
    assert tmk.trace_tables(one, "stream")[1][12] == 0
    # the same tree without its stream table (bvh mode) walks 4-wide
    assert tbvh.wide_walk(dataclasses.replace(acc, stream_tab=None))
    # and a tree whose stack bound outgrows the kernels' stack does not
    assert not tbvh.wide_walk(dataclasses.replace(
        ts.accel, wide_stack=tbvh.WIDE_STACK))


def assert_wide_equals_binary(ts):
    assert tbvh.wide_walk(ts.accel)
    o, d = random_rays(4096, 5)
    tw, pw = tbvh.traverse_closest_wide(ts.accel, ts.geometry, o, d)
    tb, pb = tbvh.traverse_closest(ts.accel, ts.geometry, o, d)
    assert (pw >= 0).any() and (pw < 0).any()
    assert torch.equal(pw, pb) and torch.equal(tw, tb)


@pytest.mark.parametrize("name", ["ring100", "mixed"])
def test_wide_closest_equals_binary(name):
    assert_wide_equals_binary(
        tscene.from_dict(suite.bvh_scene_dict(name), device="cpu")[0])


def test_wide_closest_equals_binary_over_stream_rows(forced):
    ts = both_leaf4(spheres_cube_plane_dict())[1]
    assert ts.accel.stream_tab is not None
    assert_wide_equals_binary(ts)


@pytest.fixture(scope="module")
def twins():
    d = suite.twin_scene_dict()
    js = jscene.with_accel(jscene.from_dict(d)[0], leaf_size=1)
    ts = tscene.with_accel(tscene.from_dict(d, device="cpu")[0],
                           leaf_size=1)
    return js, ts


def test_wide_tie_order_matches_jax_kernel(twins, monkeypatch):
    js, ts = twins
    monkeypatch.delenv("RT_WIDE_BVH", raising=False)
    assert jmk._kernel_mode(js) == tmk._kernel_mode(ts) == "bvh"
    np.testing.assert_array_equal(ts.accel.wide4.numpy(),
                                  jax_table(js.accel.wide4))
    o, d, pix, samp = camera_lanes(js, 16, 12, 1)
    jcfg = jtrace.TraceConfig(max_depth=1, shadow_samples=1)
    tcfg = ttrace.TraceConfig(max_depth=1, shadow_samples=1)
    ja = tuple(jnp.asarray(a) for a in (o, d, pix, samp))
    kernel = np.asarray(jmk.trace_pallas(js, *ja, jcfg, interpret=True))
    binary = np.asarray(jtrace.trace(js, *ja, jcfg))
    lanes = as_torch(o, d, pix, samp)
    port = ttrace.trace(ts, *lanes, tcfg).numpy()
    no_wide = dataclasses.replace(ts, accel=dataclasses.replace(
        ts.accel, wide4=None))
    port_binary = ttrace.trace(no_wide, *lanes, tcfg).numpy()
    ties = np.abs(kernel - binary).max(-1) > 1e-3
    assert ties.sum() >= 5
    np.testing.assert_allclose(port, kernel, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port_binary, binary, rtol=0, atol=1e-5)


def test_wide_tie_order_same_in_stream_mode(twins, forced):
    """K5's plain version on the stream rows takes the same copies as the
    bvh-mode walk on the same tree."""
    _, ts = twins
    s = tscene.with_accel(dataclasses.replace(ts, accel=None), leaf_size=1)
    assert tmk._kernel_mode(s) == "stream" and tbvh.wide_walk(s.accel)
    lanes = as_torch(*camera_lanes(twins[0], 16, 12, 2))
    cfg = ttrace.TraceConfig(max_depth=3, shadow_samples=2)
    got = ttrace.trace(s, *lanes, cfg)
    assert got.any()
    assert torch.equal(got, ttrace.trace(ts, *lanes, cfg))
