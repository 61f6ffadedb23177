// K2: the per-pixel conservative hit mask (brute-force branch).
//
// Replaces raytrace_tpu/ops/megakernel.py:pixel_mask_pallas (:2532; the
// brute-force tests bs_hit :2631 and pln_hit :2649). One thread per pixel
// casts the pixel-center ray of the affine camera and tests it against
// every sphere and every triangle's bounding sphere, each inflated by the
// jitter-cone bound k times its distance plus eps, with forward culling;
// planes use interval arithmetic on n.d. The output over-includes pixels
// (they trace to exact black) but never excludes one that a jittered
// sample would hit. Every pixel tests every primitive (bitwise ors, no
// early exit, so the work is fixed by the shapes). What bounds it: operations, ~26 per
// primitive per pixel; it reads the small tables from the L1 cache and
// writes one byte per pixel. Thin-lens depth of field is not in this slice of the
// port, so the DoF slack terms of the TPU kernel are absent (the wrapper
// raises on DoF).
//
// cam: [origin.xyz, A.xyz, B.xyz, C.xyz, k] - direction = A + u*B + v*C.
// bs:  [nbs][4] center.xyz, radius.   pln: [npl][7] point, normal, mat.
#include "common.cuh"

extern "C" __global__ void rt_pixel_mask_kernel(
    uint8_t* __restrict__ out, int width, int n_px, float inv_w,
    float inv_h, const float* __restrict__ cam,
    const float* __restrict__ bs, int nbs, const float* __restrict__ pln,
    int npl) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_px) return;
  const float eps = 1e-3f;
  float u = (static_cast<float>(p % width) + 0.5f) * inv_w;
  float v = (static_cast<float>(p / width) + 0.5f) * inv_h;
  float ox = cam[0], oy = cam[1], oz = cam[2];
  float dx = cam[3] + u * cam[6] + v * cam[9];
  float dy = cam[4] + u * cam[7] + v * cam[10];
  float dz = cam[5] + u * cam[8] + v * cam[11];
  float k = cam[12];
  float a = dx * dx + dy * dy + dz * dz;
  float inv_a = 1.0f / a;
  float sqa = sqrtf(a);
  bool hit = false;
  for (int j = 0; j < nbs; ++j) {
    const float* s = bs + 4 * j;
    float ocx = s[0] - ox, ocy = s[1] - oy, ocz = s[2] - oz;
    float oc2 = ocx * ocx + ocy * ocy + ocz * ocz;
    float g = ocx * dx + ocy * dy + ocz * dz;
    float r = s[3];
    float dist = sqrtf(oc2);
    float R = r + (dist + r) * k + eps;
    hit = hit | ((oc2 - g * g * inv_a <= R * R) & (g >= -R * sqa));
  }
  for (int j = 0; j < npl; ++j) {
    const float* pl = pln + 7 * j;
    float denom = dx * pl[3] + dy * pl[4] + dz * pl[5];
    float num = (pl[0] - ox) * pl[3] + (pl[1] - oy) * pl[4] +
                (pl[2] - oz) * pl[5];
    hit = hit | (fabsf(denom) <= k + eps) | (num * denom > 0.0f) |
          (fabsf(num) <= eps);
  }
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
#endif
