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
//
// K1-guard (Run.soft_guard, on every main-path launch of K1 and K7).
// Replaces soft_prim_sets_fn (:1718) and soft_guard_fn (:1858) of
// raytrace_tpu/ops/megakernel.py and their use in the unroll soft-shadow
// loop (:2040-2136); the JAX loop mode runs unguarded (:1684-1685), which
// gives the same verdicts. Before a lane draws a light's soft-shadow rays,
// one conservative interval test per occluder asks whether ANY ray of the
// light's jitter cone (asin 0.1; 0.102 for margin) could put a root in
// [t_min, dist]: spheres by the sphere quadratic, triangles and boxes by
// bounding spheres, planes by |n.(q - p)| <= dist. The flags, one bit an
// occluder in the order [sph, tri, box, pln], go into three 32-bit words
// in registers (kGuardMax = 96 occluders); the sample-outer loop then
// tests each ray against the flagged occluders only, with its early exit,
// and a light with nothing flagged counts every ray unblocked without
// drawing one (soft_one_chunk). Past 96 occluders (K7 only: kChunks) the
// occluders go in chunks of 96, each chunk's flags computed in turn and
// every ray of a block of 64 not yet blocked (a bit of a 64-bit mask) drawn
// again and tested against them (soft_chunks): a ray's tests are still one
// pass over every flagged occluder in order up to its first blocker. A
// skipped occluder blocks no ray, and a ray's verdict is the OR over its
// tests whatever their order, so every verdict, and sf, is bit-identical
// to the unguarded loop. The single-chunk loop stays separate, in K7 too,
// and out of K1 the chunked one, from same-call A/Bs on the H100
// (PERF.md): the chunked form ran K1's soft shadows 30% slower on the
// textured frame, compiled into K1 beside the other, inline or not, it
// slowed the bench frame, and in K7 on the loop frame's 81 occluders it
// ran the frame 3% slower than the single-chunk loop. K1's scenes have at
// most 96 occluders (on a scene past that K1 runs the unguarded loop).
// The JAX kernel hoists all samples' directions and ORs verdicts occluder
// by occluder under a per-block lax.cond, a form made for (R,128) blocks;
// one thread per lane keeps the sample-outer order and needs no hoisted
// directions. What it saves: the soft tests of occluders out of
// the cone, at the price of one guard per (occluder, light) where the
// unguarded loop pays one test per (occluder, sample).
#pragma once

#include "bounce.cuh"

// The threads of a block of K1 and K7, and the blocks an SM that ptxas
// must leave registers for (__launch_bounds__) in each: K1 at three blocks
// of 256 (80 registers, 24 warps an SM), K7 at four (64 registers, 32
// warps), where the entries took 115-128 registers and 16 warps (PERF.md:
// the same-call A/B of 128, 256 and 384 threads and of 2, 3 and 4
// blocks).
#define RT_BRUTE_THREADS 256
#define RT_UNROLL_MIN_BLOCKS 3
#define RT_LOOP_MIN_BLOCKS 4

namespace rt {

// 3 from trace_lane + tests[5]
constexpr int kBruteCounters = 8;
constexpr int kGuardWords = 3;
constexpr int kGuardMax = 32 * kGuardWords;  // occluders a chunk

// The soft-shadow guard of one bounding sphere, given the direction-free
// terms of its test from p (oc = p - center, cc = |oc|^2 - r^2, by the
// expressions of sphere_oc): can a ray of the cone around the unit light
// direction ld put a root of t^2 + 2ut + cc = 0 in [t_min, dist]? Every
// cone direction sd has |sd.oc - ld.oc| <= 0.10013 |oc| (the chord of
// asin 0.1), so u = sd.oc lies in [u_lo, u_hi]; the largest root over that
// interval is -u_lo + sqrt(u_lo^2 - cc). The slack eps_cc + 1e-6 |oc|^2 and
// eps_t cover the rounding of the sample test (its a = |sd|^2 is 1 within
// an ulp or two). The constants are the JAX kernel's.
RT_DEV bool sphere_guard(V3 oc, float cc, float r, V3 ld, float dist) {
  const float cone = 0.102f, eps_t = 1e-4f, eps_cc = 1e-4f;
  float oc2 = cc + r * r;
  float g = oc.x * ld.x + oc.y * ld.y + oc.z * ld.z;
  float u_lo = g - cone * sqrtf(oc2);
  float slack = eps_cc + 1e-6f * oc2;
  float disc_lo = u_lo * u_lo - cc;
  float root_max = -u_lo + sqrtf(fmaxf(disc_lo, 0.0f));
  bool has = (cc <= slack) || ((u_lo <= 0.0f) && (disc_lo >= -slack));
  // far bound: the center's projection on the light ray must fall within
  // the inflated segment for any hit at t <= dist
  float R = r + cone * dist + eps_cc;
  return has && (root_max >= kTMin - eps_t) && (-g <= dist + R);
}

// The guard of triangle row tr = [v0, e1, e2, ...]: its bounding sphere
// around the centroid v0 + (e1 + e2)/3 with the farthest vertex's radius.
RT_DEV bool triangle_guard(V3 p, const float* tr, V3 ld, float dist) {
  const float third = static_cast<float>(1.0 / 3.0);
  float sx = p.x - tr[0], sy = p.y - tr[1], sz = p.z - tr[2];
  float mx = (tr[3] + tr[6]) * third;
  float my = (tr[4] + tr[7]) * third;
  float mz = (tr[5] + tr[8]) * third;
  float d0 = mx * mx + my * my + mz * mz;
  float ax = tr[3] - mx, ay = tr[4] - my, az = tr[5] - mz;
  float d1 = ax * ax + ay * ay + az * az;
  float bx = tr[6] - mx, by = tr[7] - my, bz = tr[8] - mz;
  float d2 = bx * bx + by * by + bz * bz;
  float br = sqrtf(fmaxf(d0, fmaxf(d1, d2)));
  V3 oc{sx - mx, sy - my, sz - mz};
  float oc2 = oc.x * oc.x + oc.y * oc.y + oc.z * oc.z;
  return sphere_guard(oc, oc2 - br * br, br, ld, dist);
}

// The guard of box bx = [min.xyz, max.xyz, ...]: its half-diagonal sphere.
RT_DEV bool box_guard(V3 p, const float* bx, V3 ld, float dist) {
  float ex = (bx[3] - bx[0]) * 0.5f;
  float ey = (bx[4] - bx[1]) * 0.5f;
  float ez = (bx[5] - bx[2]) * 0.5f;
  float br = sqrtf(ex * ex + ey * ey + ez * ez);
  V3 oc{p.x - (bx[0] + bx[3]) * 0.5f, p.y - (bx[1] + bx[4]) * 0.5f,
        p.z - (bx[2] + bx[5]) * 0.5f};
  float oc2 = oc.x * oc.x + oc.y * oc.y + oc.z * oc.z;
  return sphere_guard(oc, oc2 - br * br, br, ld, dist);
}

// The guard of plane pl = [point, normal, ...]: a hit at t <= dist moves
// at most dist along the normal, so |n.(point - p)| <= dist + eps_cc (the
// numerator of plane_t, by its expression).
RT_DEV bool plane_guard(V3 p, const float* pl, float dist) {
  float num = (pl[0] - p.x) * pl[3] + (pl[1] - p.y) * pl[4] +
              (pl[2] - p.z) * pl[5];
  return fabsf(num) <= dist + 1e-4f;
}

// Work: occlusion tests of spheres and planes (tests[0]) and of triangles
// and boxes (tests[1]); K1-guard's guard evaluations (tests[2]), the
// occluders they flagged (tests[3]) and the soft-shadow rays left undrawn
// (tests[4]: the rays of a block where no chunk flagged an occluder).
// With more than 64 soft-shadow rays and more than kGuardMax occluders
// the guards run again for each block of 64 rays.
template <bool kLdg, bool kChunks>
struct BruteGeo {
  static constexpr int kSphMat = 4;  // sph row: center.xyz, radius, mat
  const Tables& tb;
  bool guard;  // run.soft_guard
  int tests[5];

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

  // Occluder i of the guard's order [sph, tri, box, pln] (occluded's).
  RT_DEV bool guard_one(int i, V3 p, V3 ld, float dist) {
    float row[9];
    if (i < tb.ns) {
      load_row<kLdg>(tb.sph + 5 * i, 4, row);
      V3 oc;
      float cc = sphere_oc(p, row, &oc);
      return sphere_guard(oc, cc, row[3], ld, dist);
    }
    i -= tb.ns;
    if (i < tb.nt) {
      load_row<kLdg>(tb.tri + tb.tri_cols * i, 9, row);
      return triangle_guard(p, row, ld, dist);
    }
    i -= tb.nt;
    if (i < tb.nb) {
      load_row<kLdg>(tb.box + 7 * i, 6, row);
      return box_guard(p, row, ld, dist);
    }
    load_row<kLdg>(tb.pln + 7 * (i - tb.nb), 6, row);
    return plane_guard(p, row, dist);
  }

  // The occlusion test of the flagged occluders of the chunk from c0 only
  // (bit k of can: occluder c0 + k), in occluded's order and with its
  // early exit and counters.
  RT_DEV bool occluded_flagged(V3 o, V3 d, float t_max, const uint32_t* can,
                               int c0) {
    float a = dot3(d, d);
    float inv_a = 1.0f / a;
    V3 inv = safe_inverse(d);
    float row[9];
    for (int w = 0; w < kGuardWords; ++w) {
      uint32_t bits = can[w];
      while (bits != 0u) {
        int i = c0 + 32 * w + (ffs32(bits) - 1);
        bits &= bits - 1u;
        bool hit;
        if (i < tb.ns) {
          ++tests[0];
          load_row<kLdg>(tb.sph + 5 * i, 4, row);
          hit = sphere_t(o, d, a, inv_a, row, t_max) < kBig;
        } else if ((i -= tb.ns) < tb.nt) {
          ++tests[1];
          load_row<kLdg>(tb.tri + tb.tri_cols * i, 9, row);
          hit = triangle_blocked(o, d, row, t_max);
        } else if ((i -= tb.nt) < tb.nb) {
          ++tests[1];
          load_row<kLdg>(tb.box + 7 * i, 6, row);
          hit = box_blocked(o, inv, row, t_max);
        } else {
          ++tests[0];
          load_row<kLdg>(tb.pln + 7 * (i - tb.nb), 6, row);
          hit = plane_t(o, d, row, t_max) < kBig;
        }
        if (hit) return true;
      }
    }
    return false;
  }

  // One occlusion ray per soft-shadow sample, for any sample count; with
  // K1-guard, only against the occluders its guard flags.
  RT_DEV float soft_unblocked(V3 p, V3 ld, float dist, const SoftRays& rays) {
    const int n_occl = tb.ns + tb.nt + tb.nb + tb.npl;
    if (guard && n_occl <= kGuardMax) return soft_one_chunk(p, ld, dist, rays);
    if (kChunks && guard) return soft_chunks(p, ld, dist, rays, n_occl);
    float unblocked = 0.0f;
    for (int s = 0; s < rays.samples; ++s) {
      V3 sd = soft_dir(rays, ld, s);
      unblocked += occluded(p, sd, dist) ? 0.0f : 1.0f;
    }
    return unblocked;
  }

  // The flags of the chunk of occluders [c0, c0 + n), n <= kGuardMax (bit
  // k: occluder c0 + k); false when none is flagged.
  RT_DEV bool flag_chunk(int c0, int n, V3 p, V3 ld, float dist,
                         uint32_t* can) {
    uint32_t any = 0u;
    for (int w = 0; w < kGuardWords; ++w) can[w] = 0u;
    for (int k = 0; k < n; ++k) {
      if (guard_one(c0 + k, p, ld, dist)) {
        can[k >> 5] |= 1u << (k & 31);
        ++tests[3];
      }
    }
    tests[2] += n;
    for (int w = 0; w < kGuardWords; ++w) any |= can[w];
    return any != 0u;
  }

  // Up to kGuardMax occluders (every K1 scene): one chunk, each ray drawn
  // once and tested against the flagged occluders.
  RT_DEV float soft_one_chunk(V3 p, V3 ld, float dist, const SoftRays& rays) {
    uint32_t can[kGuardWords];
    if (!flag_chunk(0, tb.ns + tb.nt + tb.nb + tb.npl, p, ld, dist, can)) {
      tests[4] += rays.samples;  // nothing can block: every ray unblocked
      return static_cast<float>(rays.samples);
    }
    float unblocked = 0.0f;
    for (int s = 0; s < rays.samples; ++s) {
      V3 sd = soft_dir(rays, ld, s);
      unblocked += occluded_flagged(p, sd, dist, can, 0) ? 0.0f : 1.0f;
    }
    return unblocked;
  }

  // Past kGuardMax occluders: chunk by chunk, in blocks of 64 rays whose
  // blocked rays are the bits of a mask, each ray drawn again for each
  // chunk that flags an occluder while it is unblocked.
  RT_DEV float soft_chunks(V3 p, V3 ld, float dist, const SoftRays& rays,
                           int n_occl) {
    int blocked = 0;
    for (int s0 = 0; s0 < rays.samples; s0 += 64) {
      const int S = rays.samples - s0 < 64 ? rays.samples - s0 : 64;
      const uint64_t full =
          S >= 64 ? ~0ull : ((1ull << static_cast<uint64_t>(S)) - 1ull);
      uint64_t bm = 0;  // bit s: ray s0 + s is blocked
      bool drawn = false;
      for (int c0 = 0; c0 < n_occl && bm != full; c0 += kGuardMax) {
        uint32_t can[kGuardWords];
        const int n = n_occl - c0 < kGuardMax ? n_occl - c0 : kGuardMax;
        if (!flag_chunk(c0, n, p, ld, dist, can)) continue;
        drawn = true;
        for (int s = 0; s < S; ++s) {
          if (bm >> s & 1ull) continue;
          V3 sd = soft_dir(rays, ld, s0 + s);
          if (occluded_flagged(p, sd, dist, can, c0)) bm |= 1ull << s;
        }
      }
      if (!drawn) tests[4] += S;  // nothing can block: every ray unblocked
      blocked += popc64(bm);
    }
    return static_cast<float>(rays.samples - blocked);
  }

  RT_DEV void store_work(int32_t* out) {
    for (int k = 0; k < 5; ++k) out[k] = tests[k];
  }
};

// One lane of K1 (kChunks false) or K7 over the tables tb.
template <bool kLdg, bool kState, bool kChunks>
RT_DEV void brute_lane(const Tables& tb, const Lanes& io, const Run& run,
                       int lane) {
  BruteGeo<kLdg, kChunks> geo{tb, run.soft_guard != 0, {0, 0, 0, 0, 0}};
  run_lane<kState>(geo, tb, io, run, lane, kBruteCounters);
}

}  // namespace rt
