// K1: the bounce megakernel for scenes of at most 96 primitives.
//
// Replaces raytrace_tpu/ops/megakernel.py:trace_pallas (:2987) built by
// _make_kernel(mode="unroll") (:278; kernel :772, closest_hit :370,
// _box_closest :454, occl_precompute :499, any_hit_pre :550, bounce body
// :1876). Semantics are those of the plain version, trace.py:trace, which
// is checked lane for lane against the JAX engine.
//
// Design for Hopper. One thread traces one lane through the whole depth
// loop (bounce.cuh); lanes are flat (B,) arrays. The scene tables (<= 96
// primitives, 14-column material rows, lights; a few KB) are copied once
// per block into shared memory, where every thread of a warp reads the
// same row at the same time (a broadcast). Primitive loops take their
// counts at run time - the TPU kernel's full unroll was an artifact of
// Mosaic's compile-time shapes - and test every primitive (brute force,
// the UnrollGeo policy below). The bounce, light and soft-shadow loops
// have static upper bounds (RT_MAX_*; the wrapper refuses larger settings)
// and no loop waits on data. Occlusion tests stop at the first blocker,
// which leaves the verdict unchanged. What bounds it: operations, not
// bytes - each lane reads 32 bytes and writes 12, but a bounce runs up to
// 1 + lights * (1 + samples) rays against every primitive. Divergence
// between lanes of a warp (a glass lane bouncing 50 times beside a dead
// one) is the cost this simple design accepts; survivor re-compaction is
// later work.
//
// Table layout: bounce.cuh, in the order sph, tri, pln, box, lit, mat.
#include "bounce.cuh"

namespace rt {

constexpr int kUnrollCounters = 5;  // 3 from trace_lane + tests[2]

// Brute force over every primitive. Work: occlusion tests of spheres and
// planes (tests[0]) and of triangles and boxes (tests[1]).
struct UnrollGeo {
  const Tables& tb;
  int tests[2];

  // First minimum over [sph, tri, pln, box] (strict <, in table order).
  RT_DEV void closest(V3 o, V3 d, float* t_out, int* kind_out,
                      int* idx_out) {
    float t = kBig;
    int kind_hit = -1, idx = 0;
    float a = dot3(d, d);
    float inv_a = 1.0f / a;
    for (int j = 0; j < tb.ns; ++j) {
      float tj = sphere_t(o, d, a, inv_a, tb.sph + 5 * j, kBig);
      if (tj < t) { t = tj; kind_hit = 0; idx = j; }
    }
    for (int j = 0; j < tb.nt; ++j) {
      float tj = triangle_t(o, d, tb.tri + 13 * j, kBig);
      if (tj < t) { t = tj; kind_hit = 1; idx = j; }
    }
    for (int j = 0; j < tb.npl; ++j) {
      float tj = plane_t(o, d, tb.pln + 7 * j, kBig);
      if (tj < t) { t = tj; kind_hit = 2; idx = j; }
    }
    if (tb.nb > 0) {
      V3 inv = safe_inverse(d);
      for (int j = 0; j < tb.nb; ++j) {
        float tj = box_t(o, inv, tb.box + 7 * j, kBig);
        if (tj < t) { t = tj; kind_hit = 3; idx = j; }
      }
    }
    *t_out = t;
    *kind_out = kind_hit;
    *idx_out = idx;
  }

  // Any hit in [t_min, t_max]; stops at the first blocker.
  RT_DEV bool occluded(V3 o, V3 d, float t_max) {
    float a = dot3(d, d);
    float inv_a = 1.0f / a;
    for (int j = 0; j < tb.ns; ++j) {
      ++tests[0];
      if (sphere_t(o, d, a, inv_a, tb.sph + 5 * j, t_max) < kBig) return true;
    }
    for (int j = 0; j < tb.nt; ++j) {
      ++tests[1];
      if (triangle_blocked(o, d, tb.tri + 13 * j, t_max)) return true;
    }
    if (tb.nb > 0) {
      V3 inv = safe_inverse(d);
      for (int j = 0; j < tb.nb; ++j) {
        ++tests[1];
        if (box_blocked(o, inv, tb.box + 7 * j, t_max)) return true;
      }
    }
    for (int j = 0; j < tb.npl; ++j) {
      ++tests[0];
      if (plane_t(o, d, tb.pln + 7 * j, t_max) < kBig) return true;
    }
    return false;
  }

  // One occlusion ray per soft-shadow sample.
  RT_DEV float soft_unblocked(V3 p, V3 ld, float dist, const SoftRays& rays) {
    float unblocked = 0.0f;
    for (int s = 0; s < RT_MAX_SHADOW_SAMPLES; ++s) {
      if (s >= rays.samples) break;
      V3 sd = soft_dir(rays, ld, s);
      unblocked += occluded(p, sd, dist) ? 0.0f : 1.0f;
    }
    return unblocked;
  }

  RT_DEV void store_work(int32_t* out) {
    out[0] = tests[0];
    out[1] = tests[1];
  }
};

}  // namespace rt

extern "C" __global__ void rt_trace_unroll_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const int32_t* __restrict__ pix, const int32_t* __restrict__ samp,
    float* __restrict__ radiance, int32_t* __restrict__ counters,
    int n_lanes, const float* __restrict__ tables, int n_table, int ns,
    int nt, int npl, int nb, int nl, int nm, int max_depth,
    int shadow_samples, int soft, int recursive, uint32_t seed) {
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < n_table; i += blockDim.x) smem[i] = tables[i];
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  rt::Tables tb;
  tb.sph = smem;
  tb.tri = tb.sph + 5 * ns;
  tb.pln = tb.tri + 13 * nt;
  tb.box = tb.pln + 7 * npl;
  tb.lit = tb.box + 7 * nb;
  tb.mat = tb.lit + 7 * nl;
  tb.ns = ns;
  tb.nt = nt;
  tb.npl = npl;
  tb.nb = nb;
  tb.nl = nl;
  tb.nm = nm;
  rt::UnrollGeo geo{tb, {0, 0}};
  const float* o = origin + 3 * lane;
  const float* d = direction + 3 * lane;
  rt::trace_lane(geo, tb, rt::V3{o[0], o[1], o[2]}, rt::V3{d[0], d[1], d[2]},
                 static_cast<uint32_t>(pix[lane]),
                 static_cast<uint32_t>(samp[lane]), max_depth, shadow_samples,
                 soft != 0, recursive != 0, seed, radiance + 3 * lane,
                 counters == nullptr ? nullptr
                                     : counters + rt::kUnrollCounters * lane);
}

#ifndef RT_HOST_EMULATION
// Launch K1 on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int rt_trace_unroll(const float* origin, const float* direction,
                               const int32_t* pix, const int32_t* samp,
                               float* radiance, int32_t* counters,
                               int n_lanes, const float* tables, int ns,
                               int nt, int npl, int nb, int nl, int nm,
                               int max_depth, int shadow_samples, int soft,
                               int recursive, uint32_t seed, void* stream) {
  const int threads = 128;
  int n_table = 5 * ns + 13 * nt + 7 * npl + 7 * nb + 7 * nl + 14 * nm;
  size_t smem = static_cast<size_t>(n_table) * sizeof(float);
  if (n_lanes > 0) {
    int blocks = (n_lanes + threads - 1) / threads;
    rt_trace_unroll_kernel<<<blocks, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        origin, direction, pix, samp, radiance, counters, n_lanes, tables,
        n_table, ns, nt, npl, nb, nl, nm, max_depth, shadow_samples, soft,
        recursive, seed);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
