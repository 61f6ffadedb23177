// The brute-force geometry policy of bounce.cuh: every ray tests every
// primitive. K1 (trace_unroll.cu) and K7 (trace_loop.cu) run it.
//
// Replaces closest_hit (:370) and any_hit_pre (:550) of the unroll mode
// and closest_hit_loop (:608) and any_hit_loop (:690) of the loop mode in
// raytrace_tpu/ops/megakernel.py: the unroll/loop split there is an
// artifact of Mosaic's compile-time shapes; here every primitive loop takes
// its count at run time, so one policy serves both modes. Its verdicts are
// those of ops/intersect.py: the first minimum in the order [sph, tri, pln,
// box] (strict <), and the occlusion tests of the hit triangles (cube faces
// are left out: their boxes are the hit form) and the boxes.
//
// kLdg: the tables lie in global memory and rows are read through the
// read-only cache (K7 past its shared-memory budget); otherwise they lie
// in shared memory, where every thread of a warp reads the same row at
// the same time (a broadcast).
#pragma once

#include "bounce.cuh"

namespace rt {

constexpr int kBruteCounters = 5;  // 3 from trace_lane + tests[2]

// Work: occlusion tests of spheres and planes (tests[0]) and of triangles
// and boxes (tests[1]).
template <bool kLdg>
struct BruteGeo {
  static constexpr int kSphMat = 4;  // sph row: center.xyz, radius, mat
  const Tables& tb;
  int tests[2];

  RT_DEV const float* sphere_row(int i) const { return tb.sph + 5 * i; }
  RT_DEV const float* triangle_row(int i) const {
    return tb.tri + tb.tri_cols * i;
  }

  // First minimum over [sph, tri, pln, box] (strict <, in table order).
  RT_DEV void closest(V3 o, V3 d, float* t_out, int* kind_out,
                      int* idx_out) {
    float t = kBig;
    int kind_hit = -1, idx = 0;
    float a = dot3(d, d);
    float inv_a = 1.0f / a;
    float row[9];
    for (int j = 0; j < tb.ns; ++j) {
      load_row<kLdg>(tb.sph + 5 * j, 4, row);
      float tj = sphere_t(o, d, a, inv_a, row, kBig);
      if (tj < t) { t = tj; kind_hit = 0; idx = j; }
    }
    for (int j = 0; j < tb.nt; ++j) {
      load_row<kLdg>(tb.tri + tb.tri_cols * j, 9, row);
      float tj = triangle_t(o, d, row, kBig);
      if (tj < t) { t = tj; kind_hit = 1; idx = j; }
    }
    for (int j = 0; j < tb.npl; ++j) {
      load_row<kLdg>(tb.pln + 7 * j, 6, row);
      float tj = plane_t(o, d, row, kBig);
      if (tj < t) { t = tj; kind_hit = 2; idx = j; }
    }
    if (tb.nb > 0) {
      V3 inv = safe_inverse(d);
      for (int j = 0; j < tb.nb; ++j) {
        load_row<kLdg>(tb.box + 7 * j, 6, row);
        float tj = box_t(o, inv, row, kBig);
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
    float row[9];
    for (int j = 0; j < tb.ns; ++j) {
      ++tests[0];
      load_row<kLdg>(tb.sph + 5 * j, 4, row);
      if (sphere_t(o, d, a, inv_a, row, t_max) < kBig) return true;
    }
    for (int j = 0; j < tb.nt; ++j) {
      ++tests[1];
      load_row<kLdg>(tb.tri + tb.tri_cols * j, 9, row);
      if (triangle_blocked(o, d, row, t_max)) return true;
    }
    if (tb.nb > 0) {
      V3 inv = safe_inverse(d);
      for (int j = 0; j < tb.nb; ++j) {
        ++tests[1];
        load_row<kLdg>(tb.box + 7 * j, 6, row);
        if (box_blocked(o, inv, row, t_max)) return true;
      }
    }
    for (int j = 0; j < tb.npl; ++j) {
      ++tests[0];
      load_row<kLdg>(tb.pln + 7 * j, 6, row);
      if (plane_t(o, d, row, t_max) < kBig) return true;
    }
    return false;
  }

  // One occlusion ray per soft-shadow sample, for any sample count.
  RT_DEV float soft_unblocked(V3 p, V3 ld, float dist, const SoftRays& rays) {
    float unblocked = 0.0f;
    for (int s = 0; s < rays.samples; ++s) {
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

// One thread, one lane: the shared entry of K1 and K7 over the tables tb.
template <bool kLdg, bool kState>
RT_DEV void brute_lane(const Tables& tb, const Lanes& io, const Run& run,
                       int lane) {
  BruteGeo<kLdg> geo{tb, {0, 0}};
  run_lane<kState>(geo, tb, io, run, lane, kBruteCounters);
}

}  // namespace rt
