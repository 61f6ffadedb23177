// Device helpers shared by the port's CUDA kernels.
//
// Each function mirrors, operation for operation, its counterpart in the
// plain PyTorch path (raytrace_tpu_torch/rng.py, ops/intersect.py), which
// in turn mirrors the JAX package. The kernels are built with -fmad=false
// and without fast math, so every float operation here rounds as the plain
// version's does: a mismatch means a change of meaning, not of rounding.
// Dot products sum x, y, z in that order.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#ifndef RT_HOST_EMULATION
#include <cuda_runtime.h>
#define RT_DEV __device__ __forceinline__
#define RT_HD __host__ __device__ inline
#else
#define RT_DEV inline
#define RT_HD inline
#endif

namespace rt {

// A load through the read-only data cache (tables that no thread writes).
RT_DEV float ldg(const float* p) {
#ifndef RT_HOST_EMULATION
  return __ldg(p);
#else
  return *p;
#endif
}

RT_DEV int popc64(uint64_t x) {
#ifndef RT_HOST_EMULATION
  return __popcll(x);
#else
  return __builtin_popcountll(x);
#endif
}

// 1 + the index of the lowest set bit, 0 for none.
RT_DEV int ffs32(uint32_t x) {
#ifndef RT_HOST_EMULATION
  return __ffs(static_cast<int>(x));
#else
  return __builtin_ffs(static_cast<int>(x));
#endif
}

// A table load: through the read-only cache when the table lies in global
// memory (kLdg), plainly when it lies in shared memory, where __ldg does
// not apply.
template <bool kLdg>
RT_DEV float ld(const float* p) {
  return kLdg ? ldg(p) : *p;
}

#ifndef RT_HOST_EMULATION
using F4 = float4;
#else
struct alignas(16) F4 {
  float x, y, z, w;
};
#endif

// Four floats at a 16-byte aligned address, in one load.
template <bool kLdg>
RT_DEV F4 ld4(const float* p) {
#ifndef RT_HOST_EMULATION
  const float4* q = reinterpret_cast<const float4*>(p);
  return kLdg ? __ldg(q) : *q;
#else
  F4 v;
  memcpy(&v, p, sizeof(v));
  return v;
#endif
}

// Copy n floats of a table row into registers (ld).
template <bool kLdg>
RT_DEV void load_row(const float* src, int n, float* dst) {
  for (int k = 0; k < n; ++k) dst[k] = ld<kLdg>(src + k);
}

// ------------------------------------------------- persistent blocks ----
// The trace kernels K1, K3+K4 and K7 run persistent blocks: as many as are
// resident on the card (persistent_blocks), each copying its table into
// shared memory once (copy_to_smem), and each warp taking the next 32
// lanes from a lane counter that the launcher zeroes on the stream just
// before the kernel (for_lanes).
// Under RT_HOST_EMULATION a warp is one thread that takes one lane at a
// time.
#ifndef RT_HOST_EMULATION
constexpr int kWarpLanes = 32;
#else
constexpr int kWarpLanes = 1;
#endif

// The first of the next kWarpLanes lanes of a persistent launch, the same
// for every thread of the warp (the warp must be converged).
RT_DEV int take_lanes(int32_t* next) {
#ifndef RT_HOST_EMULATION
  int first = 0;
  if ((threadIdx.x & 31u) == 0u) first = atomicAdd(next, kWarpLanes);
  return __shfl_sync(0xffffffffu, first, 0);
#else
  int first = *next;
  *next += kWarpLanes;
  return first;
#endif
}

// f(lane) for every lane this thread takes, until the counter passes n.
// Consecutive lanes are samples of one pixel, so a warp's rays stay
// coherent. (Asking for the next lanes before running these, to hide the
// atomic's round trip, ran K1 and K7 slower in a same-call A/B on the
// H100; PERF.md.)
template <class F>
RT_DEV void for_lanes(int n, int32_t* next, F&& f) {
  const int in_warp = static_cast<int>(threadIdx.x) % kWarpLanes;
  for (;;) {
    int first = take_lanes(next);
    if (first >= n) break;
    int lane = first + in_warp;
    if (lane < n) f(lane);
  }
}

// Copy n floats from src (global memory, 16-byte aligned) to dst (shared
// memory, 16-byte aligned) with the threads of the block, in 16-byte
// loads, then the tail of fewer than 4 floats. The caller synchronises.
RT_DEV void copy_to_smem(float* dst, const float* src, int n) {
  const int n4 = n & ~3;
  const int t = static_cast<int>(threadIdx.x);
  const int nt = static_cast<int>(blockDim.x);
  for (int i = 4 * t; i < n4; i += 4 * nt)
    *reinterpret_cast<F4*>(dst + i) = ld4<true>(src + i);
  for (int i = n4 + t; i < n; i += nt) dst[i] = ldg(src + i);
}

#ifndef RT_HOST_EMULATION
// The current device's SM count, read once.
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 1;
  if (counts[dev] == 0) {
    cudaDeviceProp prop;
    cudaGetDeviceProperties(&prop, dev);
    counts[dev] = prop.multiProcessorCount;
  }
  return counts[dev];
}

// The blocks of a persistent launch of `kernel` over n_lanes lanes: as
// many as are resident at `threads` threads and `smem` bytes of dynamic
// shared memory a block (the occupancy at the entry's registers times the
// SM count), and no more than the lanes fill. Above 48 KB the entry opts
// in to the device's largest block of shared memory first. The answer is
// kept per (entry, threads, bytes, device), so a repeated launch makes no
// occupancy query. A launch that cannot run at all (too much shared
// memory) still gets one block an SM, and reports why through
// cudaGetLastError().
template <class Kernel>
inline int persistent_blocks(Kernel kernel, int threads, size_t smem,
                             int n_lanes) {
  struct Seen {
    const void* fn;
    int threads, dev, blocks;
    size_t smem;
  };
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const void* fn = reinterpret_cast<const void*>(kernel);
  int blocks = 0;
  for (int i = 0; i < n_seen && blocks == 0; ++i)
    if (seen[i].fn == fn && seen[i].threads == threads &&
        seen[i].smem == smem && seen[i].dev == dev)
      blocks = seen[i].blocks;
  if (blocks == 0) {
    if (smem > 48 * 1024) {
      int optin = 0;
      cudaDeviceGetAttribute(&optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin);
    }
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    blocks = sm_count() * (per_sm < 1 ? 1 : per_sm);
    if (per_sm >= 1 && n_seen < 64)
      seen[n_seen++] = Seen{fn, threads, dev, blocks, smem};
  }
  int need = (n_lanes + threads - 1) / threads;
  return blocks < need ? blocks : need;
}
#endif

constexpr float kBig = 3.0e38f;   // "no hit" distance
constexpr float kTMin = 1e-3f;    // t_min of every ray
constexpr uint32_t kStreamsPerBounce = 512u;
constexpr uint32_t kShadowBase = 8u;
constexpr uint32_t kScatterBall = 1u;
constexpr uint32_t kDielectric = 2u;
constexpr uint32_t kRussianRoulette = 3u;

// ---------------------------------------------------------------- RNG ----
// pcg4d (Jarzynski & Olano 2020) in native uint32: rng.py:pcg4d.
RT_DEV void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z, uint32_t& w) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  w = w * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
}

RT_DEV float unit_float(uint32_t u) {
  return static_cast<float>(u >> 8) * (1.0f / 16777216.0f);
}

RT_DEV void uniform4(uint32_t pix, uint32_t samp, uint32_t stream,
                     uint32_t seed, float u[4]) {
  uint32_t x = pix, y = samp, z = stream, w = seed;
  pcg4d(x, y, z, w);
  u[0] = unit_float(x);
  u[1] = unit_float(y);
  u[2] = unit_float(z);
  u[3] = unit_float(w);
}

// rng.py:sincos_2pi - quadrant reduction + short Taylor polynomials.
RT_DEV void sincos_2pi(float u, float* sin_out, float* cos_out) {
  const float half_pi = static_cast<float>(1.5707963267948966);
  const float s3 = static_cast<float>(-1.0 / 6.0);
  const float s5 = static_cast<float>(1.0 / 120.0);
  const float s7 = static_cast<float>(-1.0 / 5040.0);
  const float c4 = static_cast<float>(1.0 / 24.0);
  const float c6 = static_cast<float>(-1.0 / 720.0);
  float t = 4.0f * u;
  float q = floorf(t + 0.5f);
  float r = (t - q) * half_pi;
  float r2 = r * r;
  float s = r * (1.0f + r2 * (s3 + r2 * (s5 + r2 * s7)));
  float c = 1.0f + r2 * (-0.5f + r2 * (c4 + r2 * c6));
  int qm = static_cast<int>(q) & 3;
  *sin_out = qm == 0 ? s : (qm == 1 ? c : (qm == 2 ? -s : -c));
  *cos_out = qm == 0 ? c : (qm == 1 ? -s : (qm == 2 ? -c : s));
}

// rng.py:cbrt01 - bit-level seed (the int32 bits are positive, so C's
// truncating division is the floor division of the JAX package) and two
// Newton steps with IEEE division.
RT_DEV float cbrt01(float u) {
  const float third = static_cast<float>(1.0 / 3.0);
  bool zero = u <= 0.0f;
  float x = zero ? 1.0f : u;
  int32_t i;
  float g;
  memcpy(&i, &x, 4);
  int32_t gi = i / 3 + 0x2A514067;
  memcpy(&g, &gi, 4);
  for (int k = 0; k < 2; ++k) g = (2.0f * g + x / (g * g)) * third;
  return zero ? 0.0f : g;
}

// rng.py:unit_ball
RT_DEV void unit_ball(uint32_t pix, uint32_t samp, uint32_t stream,
                      uint32_t seed, float b[3]) {
  float u[4];
  uniform4(pix, samp, stream, seed, u);
  float z = 2.0f * u[0] - 1.0f;
  float sp, cp;
  sincos_2pi(u[1], &sp, &cp);
  float rho = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  float r = cbrt01(u[2]);
  b[0] = r * rho * cp;
  b[1] = r * rho * sp;
  b[2] = r * z;
}

// ------------------------------------------------------------ vectors ----
struct V3 {
  float x, y, z;
};

RT_DEV float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// Go's Normalize: the zero vector stays zero.
RT_DEV V3 normalize3(V3 v) {
  float n = sqrtf(dot3(v, v));
  if (n > 0.0f) return V3{v.x / n, v.y / n, v.z / n};
  return V3{0.0f, 0.0f, 0.0f};
}

// ------------------------------------------------------- intersection ----
// The direction-free terms of the sphere test: oc = o - center and
// c = |oc|^2 - r^2 for s = [cx, cy, cz, r] (sphere_t and the soft-shadow
// guard of brute_force.cuh, which must see the same c).
RT_DEV float sphere_oc(V3 o, const float* s, V3* oc) {
  float ocx = o.x - s[0], ocy = o.y - s[1], ocz = o.z - s[2];
  *oc = V3{ocx, ocy, ocz};
  return (ocx * ocx + ocy * ocy + ocz * ocz) - s[3] * s[3];
}

// ops/intersect.py:sphere_t for one sphere s = [cx, cy, cz, r]; a = |d|^2.
RT_DEV float sphere_t(V3 o, V3 d, float a, float inv_a, const float* s,
                      float t_max) {
  V3 oc;
  float c = sphere_oc(o, s, &oc);
  float half_b = oc.x * d.x + oc.y * d.y + oc.z * d.z;
  float disc = half_b * half_b - a * c;
  if (!(disc >= 0.0f)) return kBig;
  float sq = sqrtf(disc);
  float r0 = (-half_b - sq) * inv_a;
  if (r0 >= kTMin && r0 <= t_max) return r0;
  float r1 = (-half_b + sq) * inv_a;
  if (r1 >= kTMin && r1 <= t_max) return r1;
  return kBig;
}

// ops/intersect.py:triangle_t (Moller-Trumbore) for tri = [v0, e1, e2, ...].
RT_DEV float triangle_t(V3 o, V3 d, const float* tri, float t_max) {
  float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  float hx = d.y * e2z - d.z * e2y;
  float hy = d.z * e2x - d.x * e2z;
  float hz = d.x * e2y - d.y * e2x;
  float det = e1x * hx + e1y * hy + e1z * hz;
  if (fabsf(det) < 1e-6f) return kBig;
  float f = 1.0f / det;
  float sx = o.x - tri[0], sy = o.y - tri[1], sz = o.z - tri[2];
  float u = f * (sx * hx + sy * hy + sz * hz);
  float qx = sy * e1z - sz * e1y;
  float qy = sz * e1x - sx * e1z;
  float qz = sx * e1y - sy * e1x;
  float v = f * (d.x * qx + d.y * qy + d.z * qz);
  float t = f * (e2x * qx + e2y * qy + e2z * qz);
  bool valid = (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
               (u + v <= 1.0f) && (t >= kTMin) && (t <= t_max);
  return valid ? t : kBig;
}

// ops/intersect.py:triangle_blocked - the division-free any-hit, split
// into the part that does not depend on the direction (TriPre, shared by
// every ray from one origin) and the per-direction test.
struct TriPre {
  float n2x, n2y, n2z, c1x, c1y, c1z, qx, qy, qz, e2q;
};

RT_DEV TriPre tri_pre(V3 o, const float* tri) {
  float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  float sx = o.x - tri[0], sy = o.y - tri[1], sz = o.z - tri[2];
  TriPre T;
  T.n2x = e1y * e2z - e1z * e2y;
  T.n2y = e1z * e2x - e1x * e2z;
  T.n2z = e1x * e2y - e1y * e2x;
  T.c1x = e2y * sz - e2z * sy;
  T.c1y = e2z * sx - e2x * sz;
  T.c1z = e2x * sy - e2y * sx;
  T.qx = sy * e1z - sz * e1y;
  T.qy = sz * e1x - sx * e1z;
  T.qz = sx * e1y - sy * e1x;
  T.e2q = e2x * T.qx + e2y * T.qy + e2z * T.qz;
  return T;
}

RT_DEV bool tri_blocked_pre(const TriPre& T, V3 d, float t_max) {
  float det = -(d.x * T.n2x + d.y * T.n2y + d.z * T.n2z);
  float sg = det >= 0.0f ? 1.0f : -1.0f;
  float ad = det * sg;
  float au = (d.x * T.c1x + d.y * T.c1y + d.z * T.c1z) * sg;
  float av = (d.x * T.qx + d.y * T.qy + d.z * T.qz) * sg;
  float at = T.e2q * sg;
  return (ad >= 1e-6f) && (au >= 0.0f) && (av >= 0.0f) && (au + av <= ad) &&
         (at >= kTMin * ad) && (at <= t_max * ad);
}

RT_DEV bool triangle_blocked(V3 o, V3 d, const float* tri, float t_max) {
  return tri_blocked_pre(tri_pre(o, tri), d, t_max);
}

// ops/intersect.py:plane_t for pl = [p.xyz, n.xyz, mat].
RT_DEV float plane_t(V3 o, V3 d, const float* pl, float t_max) {
  float denom = d.x * pl[3] + d.y * pl[4] + d.z * pl[5];
  if (denom == 0.0f) return kBig;
  float t = ((pl[0] - o.x) * pl[3] + (pl[1] - o.y) * pl[4] +
             (pl[2] - o.z) * pl[5]) / denom;
  return (t >= kTMin && t <= t_max) ? t : kBig;
}

// Slab envelope of an axis-aligned box bx = [min.xyz, max.xyz, ...] given
// the inverse direction (ops/intersect.py:_slab).
RT_DEV void box_slab(V3 o, V3 inv, const float* bx, float* near_out,
                     float* far_out) {
  float t0x = (bx[0] - o.x) * inv.x, t1x = (bx[3] - o.x) * inv.x;
  float t0y = (bx[1] - o.y) * inv.y, t1y = (bx[4] - o.y) * inv.y;
  float t0z = (bx[2] - o.z) * inv.z, t1z = (bx[5] - o.z) * inv.z;
  *near_out = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                    fminf(t0z, t1z));
  *far_out = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                   fmaxf(t0z, t1z));
}

RT_DEV V3 safe_inverse(V3 d) {
  return V3{1.0f / (d.x == 0.0f ? 1e-30f : d.x),
            1.0f / (d.y == 0.0f ? 1e-30f : d.y),
            1.0f / (d.z == 0.0f ? 1e-30f : d.z)};
}

// ops/intersect.py:box_t (closest: near crossing preferred, far fallback).
RT_DEV float box_t(V3 o, V3 inv, const float* bx, float t_max) {
  float near, far;
  box_slab(o, inv, bx, &near, &far);
  if (!(near <= far)) return kBig;
  if (near >= kTMin && near <= t_max) return near;
  if (far >= kTMin && far <= t_max) return far;
  return kBig;
}

// ops/intersect.py:box_blocked
RT_DEV bool box_blocked(V3 o, V3 inv, const float* bx, float t_max) {
  float near, far;
  box_slab(o, inv, bx, &near, &far);
  return (near <= far) && ((near >= kTMin && near <= t_max) ||
                           (far >= kTMin && far <= t_max));
}

}  // namespace rt
