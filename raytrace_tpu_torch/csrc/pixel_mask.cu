// K2, K6 and K6-stream: the per-pixel conservative hit mask.
//
// Replaces raytrace_tpu/ops/megakernel.py:pixel_mask_pallas (:2532): K2 is
// its brute-force branch (bs_hit :2631, pln_hit :2649), K6 its bvh branch
// (walk :2661-2705), K6-stream its node-only branch (node_only :2597, leaf
// mark :2691-2693). One thread per pixel casts the pixel-center ray of the
// affine camera and tests it against bounding spheres - every sphere and
// every triangle's bounding sphere - each inflated by the jitter-cone
// bound k times its distance plus eps, with forward culling; planes use
// interval arithmetic on n.d. The output over-includes pixels (they trace
// to exact black) but never excludes one that a jittered sample would hit.
//
// K2 tests every bounding sphere and every plane (bitwise ors, no early
// exit, so the work is fixed by the shapes). What bounds it: operations,
// ~28 per primitive per pixel; it reads the small tables from the L1 cache
// and writes one byte per pixel.
//
// K6 replaces the bounding-sphere loop by the skip walk over the scene
// BVH, whose node slabs the wrapper has grown per node by k times the
// distance to the node's farthest corner plus eps and an fp slack
// (megakernel.py:_mask_tree). A boxed leaf runs the bounding-sphere test
// of its primitives (through prim_index), all of them, with bitwise ors;
// a pixel's walk ends at its first hit. The planes follow as in K2.
//
// K6-stream (stream mode, past 4096 primitives) is K6's walk with the
// leaf test replaced: a pixel whose inflated slab walk reaches a leaf is
// marked. It reads no bounding-sphere table (that table is what the TPU
// could not hold at this scale), so it passes a superset of K6's pixels;
// the extra ones trace to black.
//
// Thin-lens depth of field (the DoF branch of pixel_mask_pallas: bs_hit's
// slack :2636-2646, pln_hit's lens terms :2649-2659, the camera rows
// :2741-2762; the node pad :2774-2791 is the wrapper's, _mask_tree). A DoF
// ray leaves o + e (|e| <= Le) toward o + F*d_j, so a point at distance s
// from the camera lies within Le*|D - s|/(D - Le) of the jittered pinhole
// ray (D = F*|d_j|). The bounding-sphere test takes that slack, times
// (1 + k) for the cone, with s in [dist - r, dist + r] and D in
// F*|d_c|*(1 -+ k): x = (s - Le)/(D - Le) is bounded by the numerators
// dist - r - Le and dist + r + Le over c_lo = 1/(F(1+k) + Le) and
// c_hi = 1/max(F(1-k) - Le, eps) (divided by |d_c| >= 1), a numerator
// below zero over c_hi. This is a DEPARTURE from the JAX kernel, whose
// leaf slack (x over F*|d_c|*(1 -+ k) alone, no (1 + k)) is not
// conservative: the port's DoF mask holds every pixel the JAX mask holds
// and those it drops. Planes keep the JAX kernel's kp = k + Le/(F - Le)
// on the denominator and ll = Le*(1 + kp) on the numerator. Without DoF,
// Le = ll = 0 and kp = k, and every test reduces to the pinhole form.
//
// cam: [origin.xyz, A.xyz, B.xyz, C.xyz, k, kp, ll, Le, c_lo, c_hi] -
// direction = A + u*B + v*C.
// bs:  [nbs][4] center.xyz, radius.   pln: [npl][7] point, normal, mat.
// nodes: [n_nodes][9] min.xyz, max.xyz, skip, first, count; pidx: [P].
#include "common.cuh"

namespace rt {

struct CenterRay {
  float ox, oy, oz, dx, dy, dz, k, inv_a, sqa, inv_sq;
  float kp, ll, le, c_lo, c_hi;  // thin-lens terms (0, 0 and kp = k: none)
};

RT_DEV CenterRay center_ray(int p, int width, float inv_w, float inv_h,
                            const float* cam) {
  float u = (static_cast<float>(p % width) + 0.5f) * inv_w;
  float v = (static_cast<float>(p / width) + 0.5f) * inv_h;
  CenterRay c;
  c.ox = cam[0];
  c.oy = cam[1];
  c.oz = cam[2];
  c.dx = cam[3] + u * cam[6] + v * cam[9];
  c.dy = cam[4] + u * cam[7] + v * cam[10];
  c.dz = cam[5] + u * cam[8] + v * cam[11];
  c.k = cam[12];
  c.kp = cam[13];
  c.ll = cam[14];
  c.le = cam[15];
  c.c_lo = cam[16];
  c.c_hi = cam[17];
  float a = c.dx * c.dx + c.dy * c.dy + c.dz * c.dz;
  c.inv_a = 1.0f / a;
  c.sqa = sqrtf(a);
  c.inv_sq = 1.0f / c.sqa;
  return c;
}

// The cone-inflated bounding-sphere test s = [center.xyz, radius], with
// the thin-lens slack dofl when Le > 0.
RT_DEV bool bs_hit(const CenterRay& c, const float* s) {
  const float eps = 1e-3f;
  float ocx = s[0] - c.ox, ocy = s[1] - c.oy, ocz = s[2] - c.oz;
  float oc2 = ocx * ocx + ocy * ocy + ocz * ocz;
  float g = ocx * c.dx + ocy * c.dy + ocz * c.dz;
  float r = s[3];
  float dist = sqrtf(oc2);
  float dofl = 0.0f;
  if (c.le > 0.0f) {
    float n_lo = dist - r - c.le;
    float n_hi = dist + r + c.le;
    float x_lo = n_lo * c.inv_sq * (n_lo >= 0.0f ? c.c_lo : c.c_hi);
    float x_hi = n_hi * c.inv_sq * c.c_hi;
    dofl = c.le * (1.0f + c.k) *
           fmaxf(fabsf(1.0f - x_lo), fabsf(1.0f - x_hi));
  }
  float R = r + (dist + r) * c.k + dofl + eps;
  return (oc2 - g * g * c.inv_a <= R * R) & (g >= -(R + c.ll) * c.sqa);
}

RT_DEV bool planes_hit(const CenterRay& c, const float* pln, int npl) {
  const float eps = 1e-3f;
  bool hit = false;
  for (int j = 0; j < npl; ++j) {
    const float* pl = pln + 7 * j;
    float denom = c.dx * pl[3] + c.dy * pl[4] + c.dz * pl[5];
    float num = (pl[0] - c.ox) * pl[3] + (pl[1] - c.oy) * pl[4] +
                (pl[2] - c.oz) * pl[5];
    hit = hit | (fabsf(denom) <= c.kp + eps) | (num * denom > 0.0f) |
          (fabsf(num) <= c.ll + eps);
  }
  return hit;
}

}  // namespace rt

extern "C" __global__ void rt_pixel_mask_kernel(
    uint8_t* __restrict__ out, int width, int n_px, float inv_w,
    float inv_h, const float* __restrict__ cam,
    const float* __restrict__ bs, int nbs, const float* __restrict__ pln,
    int npl) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_px) return;
  rt::CenterRay c = rt::center_ray(p, width, inv_w, inv_h, cam);
  bool hit = false;
  for (int j = 0; j < nbs; ++j) hit = hit | rt::bs_hit(c, bs + 4 * j);
  hit = hit | rt::planes_hit(c, pln, npl);
  out[p] = hit ? 1 : 0;
}

namespace rt {

// K6's walk (kNodeOnly false: bounding-sphere tests at a boxed leaf, bs
// and pidx read) or K6-stream's (true: a boxed leaf marks the pixel).
template <bool kNodeOnly>
RT_DEV bool mask_walk(const CenterRay& c, const float* bs, const float* nodes,
                      int n_nodes, const float* pidx) {
  V3 iv = safe_inverse(V3{c.dx, c.dy, c.dz});
  bool hit = false;
  int cur = 0;
  for (int step = 0; step < n_nodes && cur < n_nodes && !hit; ++step) {
    const float* nd = nodes + 9 * cur;
    float t0x = (ldg(nd) - c.ox) * iv.x;
    float t1x = (ldg(nd + 3) - c.ox) * iv.x;
    float t0y = (ldg(nd + 1) - c.oy) * iv.y;
    float t1y = (ldg(nd + 4) - c.oy) * iv.y;
    float t0z = (ldg(nd + 2) - c.oz) * iv.z;
    float t1z = (ldg(nd + 5) - c.oz) * iv.z;
    float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                       fmaxf(fminf(t0z, t1z), 0.0f));
    float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                      fmaxf(t0z, t1z));
    int skip = static_cast<int>(ldg(nd + 6));
    int cnt = static_cast<int>(ldg(nd + 8));
    if (!(near <= far)) {
      cur = skip;
    } else if (cnt == 0) {
      ++cur;
    } else if (kNodeOnly) {
      hit = true;
    } else {
      int first = static_cast<int>(ldg(nd + 7));
      for (int j = 0; j < cnt; ++j) {
        const float* s = bs + 4 * static_cast<int>(ldg(pidx + first + j));
        float row[4] = {ldg(s), ldg(s + 1), ldg(s + 2), ldg(s + 3)};
        hit = hit | bs_hit(c, row);
      }
      cur = skip;
    }
  }
  return hit;
}

}  // namespace rt

extern "C" __global__ void rt_pixel_mask_bvh_kernel(
    uint8_t* __restrict__ out, int width, int n_px, float inv_w,
    float inv_h, const float* __restrict__ cam,
    const float* __restrict__ bs, const float* __restrict__ nodes,
    int n_nodes, const float* __restrict__ pidx,
    const float* __restrict__ pln, int npl) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_px) return;
  rt::CenterRay c = rt::center_ray(p, width, inv_w, inv_h, cam);
  bool hit = rt::mask_walk<false>(c, bs, nodes, n_nodes, pidx);
  hit = hit | rt::planes_hit(c, pln, npl);
  out[p] = hit ? 1 : 0;
}

extern "C" __global__ void rt_pixel_mask_stream_kernel(
    uint8_t* __restrict__ out, int width, int n_px, float inv_w,
    float inv_h, const float* __restrict__ cam,
    const float* __restrict__ nodes, int n_nodes,
    const float* __restrict__ pln, int npl) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_px) return;
  rt::CenterRay c = rt::center_ray(p, width, inv_w, inv_h, cam);
  bool hit = rt::mask_walk<true>(c, nullptr, nodes, n_nodes, nullptr);
  hit = hit | rt::planes_hit(c, pln, npl);
  out[p] = hit ? 1 : 0;
}

#ifndef RT_HOST_EMULATION
// Launch K2 on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int rt_pixel_mask(uint8_t* out, int width, int height,
                             float inv_w, float inv_h, const float* cam,
                             const float* bs, int nbs, const float* pln,
                             int npl, void* stream) {
  const int threads = 256;
  int n_px = width * height;
  if (n_px > 0) {
    int blocks = (n_px + threads - 1) / threads;
    rt_pixel_mask_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        out, width, n_px, inv_w, inv_h, cam, bs, nbs, pln, npl);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch K6 on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int rt_pixel_mask_bvh(uint8_t* out, int width, int height,
                                 float inv_w, float inv_h, const float* cam,
                                 const float* bs, const float* nodes,
                                 int n_nodes, const float* pidx,
                                 const float* pln, int npl, void* stream) {
  const int threads = 256;
  int n_px = width * height;
  if (n_px > 0) {
    int blocks = (n_px + threads - 1) / threads;
    rt_pixel_mask_bvh_kernel<<<blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        out, width, n_px, inv_w, inv_h, cam, bs, nodes, n_nodes, pidx, pln,
        npl);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch K6-stream on `stream`. Returns cudaGetLastError() after the
// launch.
extern "C" int rt_pixel_mask_stream(uint8_t* out, int width, int height,
                                    float inv_w, float inv_h,
                                    const float* cam, const float* nodes,
                                    int n_nodes, const float* pln, int npl,
                                    void* stream) {
  const int threads = 256;
  int n_px = width * height;
  if (n_px > 0) {
    int blocks = (n_px + threads - 1) / threads;
    rt_pixel_mask_stream_kernel<<<blocks, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        out, width, n_px, inv_w, inv_h, cam, nodes, n_nodes, pln, npl);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
