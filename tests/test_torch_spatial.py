"""The port's spatial structures and host library against the JAX
package's (raytrace_tpu.bvh, raytrace_tpu.native, raytrace_tpu.utils.image).

* The SAH build's node arrays equal the JAX build's bit for bit (both
  numpy), on the JAX test's three-cluster layout and a sphere cloud, at
  three leaf sizes; the median build (native when it loads) too.
* closest_hit_bvh against the JAX function on SAH and median trees: t at
  rtol 2e-5 (the JAX test's), sphere ids equal; sphere_hit_t and
  tri_hit_t at rtol 1e-6.
* A deliberately deep SAH tree, past the kernels' 4-wide stack
  (bvh.WIDE_STACK), never takes the 4-wide walk: its trace and walk
  tables carry the binary tree, and the walks over them give brute
  force's hits.
* Octree and KD-tree: query_point, query_range, query_ray and closest_hit
  equal the JAX structures' (the same id lists; t at rtol 1e-6).
* The native library (skipped when g++ is missing, as the JAX tests are):
  its tree equals the numpy build's bit for bit; PNGs round-trip through
  the Paeth filter, the native unfilter and the Python fallback, and
  encode to the JAX package's bytes.
* tonemap.reinhard, write_pgm and scene_prim_count against the JAX ones.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytrace_tpu as jrt
from raytrace_tpu import bvh as jbvh
from raytrace_tpu import native as jnative
from raytrace_tpu import renderer as jrenderer
from raytrace_tpu.ops import tonemap as jtonemap
from raytrace_tpu.utils import image as jimage
from raytrace_tpu_torch import bvh as tbvh
from raytrace_tpu_torch import native as tnative
from raytrace_tpu_torch import renderer as trenderer
from raytrace_tpu_torch import scene as tscene
from raytrace_tpu_torch.bench.suite import deep_sah_scene_dict
from raytrace_tpu_torch.ops import intersect as tisect
from raytrace_tpu_torch.ops import megakernel as tmk
from raytrace_tpu_torch.ops import tonemap as ttonemap
from raytrace_tpu_torch.utils import image as timage

FIELDS = ("node_min", "node_max", "node_skip", "node_first", "node_count",
          "prim_index")


def _clusters():
    """The JAX SAH test's layout: three dense clusters and outliers."""
    r = np.random.default_rng(7)
    c = np.concatenate([r.normal(loc, 0.6, (40, 3)) for loc in
                        ((-8, 0, 0), (6, 5, -2), (0, -6, 7))]
                       + [r.uniform(-12, 12, (8, 3))]).astype(np.float32)
    rad = r.uniform(0.2, 0.5, c.shape[0]).astype(np.float32)
    return c, rad


def _cloud():
    r = np.random.default_rng(3)
    return (r.uniform(-10, 10, (200, 3)).astype(np.float32),
            r.uniform(0.1, 0.6, 200).astype(np.float32))


LAYOUTS = {"clusters": _clusters, "cloud": _cloud}


def _same_tree(t, j):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert t.leaf_size == j.leaf_size


@pytest.mark.parametrize("leaf", [1, 4, 16])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sah_tree_equals_jax(layout, leaf):
    c, rad = LAYOUTS[layout]()
    lo, hi = c - rad[:, None], c + rad[:, None]
    _same_tree(tbvh.build_bvh(lo, hi, leaf_size=leaf, method="sah"),
               jbvh.build_bvh(lo, hi, leaf_size=leaf, method="sah"))
    _same_tree(tbvh.build_bvh(lo, hi, leaf_size=leaf),
               jbvh.build_bvh(lo, hi, leaf_size=leaf))
    _same_tree(tbvh.build_sphere_bvh(c, rad, leaf_size=leaf),
               jbvh.build_sphere_bvh(c, rad, leaf_size=leaf))
    v0, v1, v2 = lo, hi, c
    _same_tree(tbvh.build_triangle_bvh(v0, v1, v2, leaf_size=leaf),
               jbvh.build_triangle_bvh(v0, v1, v2, leaf_size=leaf))


def test_build_bvh_rejects_unknown_method():
    with pytest.raises(ValueError):
        tbvh.build_bvh(np.zeros((2, 3)), np.ones((2, 3)), method="lbvh")


def _rand_rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-14, 14, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("method", ["median", "sah"])
def test_closest_hit_bvh_equals_jax(method):
    c, rad = _clusters()
    lo, hi = c - rad[:, None], c + rad[:, None]
    o, d = _rand_rays(1024, seed=3)
    jt = jbvh.build_bvh(lo, hi, leaf_size=4, method=method)
    tt = tbvh.build_bvh(lo, hi, leaf_size=4, method=method)
    jt_, jpid = jbvh.closest_hit_bvh(jt, jnp.asarray(c), jnp.asarray(rad),
                                     jnp.asarray(o), jnp.asarray(d))
    t_, pid = tbvh.closest_hit_bvh(tt, torch.from_numpy(c),
                                   torch.from_numpy(rad), torch.from_numpy(o),
                                   torch.from_numpy(d))
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jpid))
    np.testing.assert_allclose(t_.numpy(), np.asarray(jt_), rtol=2e-5)
    assert 0 < int((pid >= 0).sum()) < pid.shape[0]
    # and brute force's hits
    ts = tisect.sphere_t(torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(c), torch.from_numpy(rad), 1e-3,
                         tisect.BIG)
    hit = pid >= 0
    np.testing.assert_array_equal(ts.argmin(dim=1)[hit].numpy(),
                                  pid[hit].numpy())


def test_hit_t_equal_jax():
    r = np.random.default_rng(9)
    n = 257
    o, d, c, v0 = (r.normal(size=(n, 3)).astype(np.float32) for _ in range(4))
    e1, e2 = (r.normal(size=(n, 3)).astype(np.float32) for _ in range(2))
    rad = r.uniform(0.5, 2.0, n).astype(np.float32)
    tb = r.uniform(1.0, 10.0, n).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    np.testing.assert_allclose(
        tbvh.sphere_hit_t(T(o), T(d), T(c), T(rad), 1e-3, T(tb)).numpy(),
        np.asarray(jbvh.sphere_hit_t(J(o), J(d), J(c), J(rad), 1e-3,
                                     J(tb))), rtol=1e-6)
    np.testing.assert_allclose(
        tbvh.tri_hit_t(T(o), T(d), T(v0), T(e1), T(e2), 1e-3, T(tb)).numpy(),
        np.asarray(jbvh.tri_hit_t(J(o), J(d), J(v0), J(e1), J(e2), 1e-3,
                                  J(tb))), rtol=1e-6)


def test_deep_sah_tree_never_takes_the_wide_walk():
    scene, _ = tscene.from_dict(deep_sah_scene_dict(), device="cpu")
    assert tmk._kernel_mode(scene) == "bvh"
    assert tbvh.wide_walk(scene.accel)  # the median tree fits the stack
    sah = tbvh.build_scene_bvh(scene.geometry, leaf_size=1, method="sah")
    assert sah.wide_stack + 4 > tbvh.WIDE_STACK
    assert not tbvh.wide_walk(sah)
    deep = dataclasses.replace(scene, accel=sah)
    for mode in ("bvh", "stream"):
        assert tmk.trace_tables(deep, mode)[1][-1] == 0  # n_wide: binary
    walk = tmk.pack_walk_table(deep)
    n_bin = 9 * sah.n_nodes
    assert walk.numel() == n_bin + (-n_bin) % 4 + tmk.WALK_ROW * 100
    # rays from random origins at the spheres within 300 of the origin
    # (the comb's first two of each arm among them): further out, brute
    # force, the reference here, loses the radius to cancellation (its
    # |oc|^2 - r^2 at 4,913 is 2.4e7 - 0.25 in float32) and takes hits
    # outside the sphere's box
    r = np.random.default_rng(5)
    c = scene.geometry.sph_center.numpy()
    c = c[np.abs(c).max(axis=-1) < 300]
    o = r.uniform(-10, 10, (512, 3)).astype(np.float32)
    aim = c[r.integers(len(c), size=512)] + r.normal(0, 0.3, (512, 3))
    o, d = torch.from_numpy(o), torch.from_numpy((aim - o).astype(np.float32))
    t, pid = tmk.walk_table_plain(deep, o, d, 1e-3, tisect.BIG)
    brute = tisect.closest_hit(scene.geometry, o, d)
    hit = brute.hit.numpy()
    assert hit.any()
    np.testing.assert_array_equal(pid.numpy() >= 0, hit)
    np.testing.assert_allclose(t.numpy()[hit], brute.t.numpy()[hit],
                               rtol=2e-5)
    walked = tisect.closest_hit(scene.geometry, o, d, accel=sah)
    np.testing.assert_array_equal(walked.mat_id.numpy()[hit],
                                  brute.mat_id.numpy()[hit])


def _boxes():
    c, rad = _cloud()
    return c, rad, c - rad[:, None], c + rad[:, None]


def test_octree_and_kdtree_queries_equal_jax():
    c, rad, lo, hi = _boxes()
    jo, to_ = jbvh.Octree(lo, hi), tbvh.Octree(lo, hi)
    jk, tk = jbvh.KDTree(lo, hi), tbvh.KDTree(lo, hi)
    assert to_.node_count() == jo.node_count() and tk.depth() == jk.depth()
    r = np.random.default_rng(12)
    for i in (13, 50, 77):
        assert to_.query_point(c[i]) == jo.query_point(c[i])
        assert tk.query_range(c[i] - 1.5, c[i] + 1.5) == jk.query_range(
            c[i] - 1.5, c[i] + 1.5)
    for _ in range(12):
        o = r.uniform(-12, 12, 3)
        d = r.normal(size=3)
        want = jo.query_ray(o, d, 1e-3, 1e9)
        assert to_.query_ray(o, d, 1e-3, 1e9) == want
        assert tk.query_ray(o, d, 1e-3, 1e9) == jk.query_ray(o, d, 1e-3,
                                                             1e9)
        assert want == sorted(i for i in range(len(lo))
                              if tbvh._ray_aabb_host(o, d, lo[i], hi[i],
                                                     1e-3, 1e9))


def test_octree_and_kdtree_closest_hit_equal_jax():
    c, rad, lo, hi = _boxes()
    trees = [(tbvh.Octree(lo, hi), jbvh.Octree(lo, hi)),
             (tbvh.KDTree(lo, hi), jbvh.KDTree(lo, hi))]
    eye = np.float32([0, 0, 20])
    r = np.random.default_rng(11)
    for _ in range(6):
        d = c[r.integers(len(c))] - eye
        d = (d / np.linalg.norm(d)).astype(np.float32)

        def t_hit(i, t_min, t_max):
            return float(tbvh.sphere_hit_t(
                torch.from_numpy(eye), torch.from_numpy(d),
                torch.from_numpy(c[i]), torch.tensor(rad[i]), t_min, t_max))

        def j_hit(i, t_min, t_max):
            return float(jbvh.sphere_hit_t(
                jnp.asarray(eye), jnp.asarray(d), jnp.asarray(c[i]),
                jnp.float32(rad[i]), t_min, t_max))

        for tt, jt in trees:
            got = tt.closest_hit(eye, d, t_hit)
            want = jt.closest_hit(eye, d, j_hit)
            assert got[1] == want[1] and got[1] >= 0
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


def _need_native():
    if not tnative.available():
        pytest.skip("g++ unavailable: the native library did not build")


def test_native_tree_equals_numpy():
    _need_native()
    c, rad = _cloud()
    lo, hi = c - rad[:, None], c + rad[:, None]
    for leaf in (1, 4, 16):
        nat = tnative.build_bvh_native(lo, hi, leaf)
        for a, b, f in zip(nat, tbvh.flat_arrays(lo, hi, leaf), FIELDS):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert tnative.lib_path().startswith(tnative.BUILD_DIR)


def _image():
    r = np.random.default_rng(2)
    img = np.zeros((48, 64, 3), np.uint8)
    img[:16] = np.linspace(0, 255, 64)[None, :, None].astype(np.uint8)
    img[16:32] = r.integers(0, 256, (16, 64, 3), dtype=np.uint8)
    img[32:] = 128
    return img


def test_png_paeth_round_trip(tmp_path):
    _need_native()
    img = _image()
    path = str(tmp_path / "paeth.png")
    timage.write_png(path, img)
    np.testing.assert_array_equal(timage.read_png(path), img)
    np.testing.assert_array_equal(jimage.read_png(path), img)
    if jnative.available():
        assert timage.encode_png(img) == jimage.encode_png(img)
        assert (timage.encode_png(img, compress_level=9)
                == jimage.encode_png(img, compress_level=9))
    rgba = np.concatenate([img, img[..., :1]], axis=-1)
    timage.write_png(path, rgba, compress_level=1)
    np.testing.assert_array_equal(timage.read_png(path), rgba)


def test_png_native_unfilter_and_fallback(tmp_path, monkeypatch):
    _need_native()
    img = np.random.default_rng(3).integers(0, 256, (20, 30, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "f0.png")
    with monkeypatch.context() as m:  # filter 0, read natively
        m.setattr(tnative, "png_filter_paeth_native", lambda *a, **k: None)
        timage.write_png(path, img)
    np.testing.assert_array_equal(timage.read_png(path), img)
    monkeypatch.setattr(tnative, "png_filter_paeth_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(tnative, "png_unfilter_native",
                        lambda *a, **k: None)
    timage.write_png(path, img)
    np.testing.assert_array_equal(timage.read_png(path), img)
    jimage.write_png(path, img)  # the JAX package's Paeth, read in Python
    np.testing.assert_array_equal(timage.read_png(path), img)


def test_small_leftovers(tmp_path, simple_scene_dict):
    x = np.random.default_rng(4).uniform(0, 5, (7, 3)).astype(np.float32)
    np.testing.assert_allclose(ttonemap.reinhard(torch.from_numpy(x)).numpy(),
                               np.asarray(jtonemap.reinhard(jnp.asarray(x))),
                               rtol=1e-6)
    gray = np.random.default_rng(5).uniform(-0.2, 1.2, (5, 6))
    timage.write_pgm(str(tmp_path / "t.pgm"), gray)
    jimage.write_pgm(str(tmp_path / "j.pgm"), gray)
    assert (tmp_path / "t.pgm").read_text() == (tmp_path / "j.pgm").read_text()
    js, _ = jrt.scene_from_dict(simple_scene_dict)
    ts, _ = tscene.from_dict(simple_scene_dict, device="cpu")
    assert trenderer.scene_prim_count(ts) == jrenderer.scene_prim_count(js)
