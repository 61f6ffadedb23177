// K2, K6 and K6-stream: the per-pixel conservative hit mask.
//
// Replaces raytrace_tpu/ops/megakernel.py:pixel_mask_pallas (:2532): K2 is
// its brute-force branch (bs_hit :2631, pln_hit :2649), K6 its bvh branch
// (walk :2661-2705), K6-stream its node-only branch (node_only :2597, leaf
// mark :2691-2693). A thread casts a pixel's center ray of the affine
// camera and tests it against bounding spheres - every sphere and every
// triangle's bounding sphere - each inflated by the jitter-cone bound k
// times its distance plus eps, with forward culling; planes use interval
// arithmetic on n.d. The output over-includes pixels (they trace to exact
// black) but never excludes one that a jittered sample would hit.
//
// K2 tests every bounding sphere and every plane (bitwise ors, no early
// exit, so the work is fixed by the shapes), one thread a pixel. What
// bounds it: operations, ~28 per primitive per pixel; it reads the small
// tables from the L1 cache and writes one byte per pixel.
//
// K6 replaces the bounding-sphere loop by the skip walk over the scene
// BVH, whose node slabs are grown per node by k times the distance to
// the node's farthest corner plus eps and an fp slack (the padding of
// pixel_mask_pallas :2762-2793, which XLA fuses beside the TPU kernel). A
// boxed leaf runs the bounding-sphere test of its primitives, all of them,
// with bitwise ors; a pixel's walk ends at its first hit. The planes
// follow as in K2. K6-stream (stream mode, past 4096 primitives) is K6's
// walk with the leaf test replaced: a pixel whose inflated slab walk
// reaches a leaf is marked. It reads no bounding spheres (what the TPU
// could not hold at this scale), so it passes a superset of K6's pixels;
// the extra ones trace to black.
//
// K6 and K6-stream on Hopper: a walk over a mask table.
// - The mask table, built from the scene's own arrays (the tree's
//   node_min/max, skip, first, count and prim_index; for K6 the spheres
//   and triangle vertices) and the camera row: a 48-byte node row
//   [lo.xyz, skip, hi.xyz, first, count, 0, 0, 0] with the grown slab
//   (lo, hi), then for K6 one 32-byte leaf row a leaf slot, in slot order
//   (prim_index resolved), holding what bs_hit computes before it looks
//   at the pixel: [oc.xyz, |oc|^2, dist, r, R, R*R] with R the finished
//   radius, or with depth of field [oc.xyz, |oc|^2, dist, r, r + (dist +
//   r)*k, 0]. The operations are those of bs_hit and of the wrapper's
//   plain version (megakernel.mask_table_plain), in the same order, so
//   every test gives the same bits as the per-pixel form.
// - The walk (rt_pixel_mask_bvh_kernel, rt_pixel_mask_stream_kernel) runs
//   persistent blocks of 1024 threads (common.cuh), one an SM on most
//   scenes. While the table fits the wrapper's budget
//   (megakernel.MASK_SMEM_BYTES), each block builds it in its dynamic
//   shared memory in its prologue, a row a thread; each warp then takes a
//   tile of 8x4 pixels at a time, by a static stride over the tiles, so
//   the 32 center rays of a warp stay close and take similar walks. A
//   node test is two 16-byte loads (and a third at a boxed node); a leaf
//   test is a dot product and two compares (plus the thin-lens slack with
//   depth of field).
// - Past the budget (the past-cap grid's 393 KB table) the pre-pass
//   (rt_mask_table_kernel, a row a thread) writes the table to global
//   memory and the walk reads it in place, through the read-only cache,
//   by the same code (kLdg).
// Why so: on the H100 a separate pre-pass launch before every walk took
// about 3 us however small the table, and copying the table into each of
// several 256-thread blocks an SM meant some 200 KB of L2 reads an SM;
// building it per block in 1024-thread blocks was the fastest of the
// forms tried side by side (PERF.md: 256, 512 and 1024 threads, with the
// pre-pass or the prologue, 8x4 or 32x1 tiles, at most 2 blocks an SM,
// the table in place). What bounds the walk: operations - the center
// ray, slab tests, leaf tests and planes a pixel - and the prologue's
// rows on the short node-only walks.
//
// Thin-lens depth of field (the DoF branch of pixel_mask_pallas: bs_hit's
// slack :2636-2646, pln_hit's lens terms :2649-2659, the camera rows
// :2741-2762, the node pad :2774-2791). A DoF ray leaves o + e (|e| <=
// Le) toward o + F*d_j, so a point at distance s from the camera lies
// within Le*|D - s|/(D - Le) of the jittered pinhole ray (D = F*|d_j|).
// The bounding-sphere test takes that slack, times (1 + k) for the cone,
// with s in [dist - r, dist + r] and D in F*|d_c|*(1 -+ k): x = (s -
// Le)/(D - Le) is bounded by the numerators dist - r - Le and dist + r +
// Le over c_lo = 1/(F(1+k) + Le) and c_hi = 1/max(F(1-k) - Le, eps)
// (divided by |d_c| >= 1), a numerator below zero over c_hi. This is a
// DEPARTURE from the JAX kernel, whose leaf slack (x over F*|d_c|*(1 -+
// k) alone, no (1 + k)) is not conservative: the port's DoF mask holds
// every pixel the JAX mask holds and those it drops. Planes keep the JAX
// kernel's kp = k + Le/(F - Le) on the denominator and ll = Le*(1 + kp)
// on the numerator. Without DoF, Le = ll = 0 and kp = k, and every test
// reduces to the pinhole form. The node pad with DoF is the JAX kernel's,
// k*s_hi + Le*maxfac + eps over |d_j| in [1, dmax].
//
// cam: [origin.xyz, A.xyz, B.xyz, C.xyz, k, kp, ll, Le, c_lo, c_hi] -
// direction = A + u*B + v*C.
// bs:  [nbs][4] center.xyz, radius.   pln: [npl][7] point, normal, mat.
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

// -------------------------------------------- K6, K6-stream on Hopper ----

// The threads of a walk block.
#define RT_MASK_THREADS 1024

namespace rt {

constexpr int kMaskNode = 12;  // floats of a mask-table node row
constexpr int kMaskLeaf = 8;   // floats of a mask-table leaf row
constexpr int kMaskTileW = 8;  // a warp's tile of pixels: 8 x 4
constexpr int kMaskTileH = 32 / kMaskTileW;

// What the pre-pass reads: the scene's arrays as it holds them.
struct MaskScene {
  const float* node_min;    // (N,3)
  const float* node_max;    // (N,3)
  const int32_t* skip;      // (N,)
  const int32_t* first;     // (N,)
  const int32_t* count;     // (N,)
  const int32_t* pidx;      // (P,) prim_index
  const float* sph_center;  // (Ns,3)
  const float* sph_radius;  // (Ns,)
  const float* v0;          // (Nt,3) triangle vertices, cube faces too
  const float* v1;
  const float* v2;
  int n_nodes, n_slots, ns;  // n_slots 0: no leaf rows (K6-stream)
};

RT_DEV float norm3(const float* v) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

RT_DEV void st4(float* p, float a, float b, float c, float d) {
#ifndef RT_HOST_EMULATION
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
#else
  p[0] = a;
  p[1] = b;
  p[2] = c;
  p[3] = d;
#endif
}

// Node row i: the slab grown by the cone pad at its farthest corner,
// k*d_far + eps, or with depth of field k*s_hi + Le*maxfac + eps, plus
// the fp slack 1e-3*extent + 1e-3 (megakernel._mask_tree).
RT_DEV void mask_node_row(const MaskScene& s, const float* cam, float focus,
                          int dof, int i, float* dst) {
  const float eps = 1e-3f;
  const float k = cam[12];
  float mn[3], mx[3], fr[3];
  for (int a = 0; a < 3; ++a) {
    mn[a] = s.node_min[3 * i + a];
    mx[a] = s.node_max[3 * i + a];
    fr[a] = fmaxf(fabsf(mn[a] - cam[a]), fabsf(mx[a] - cam[a]));
  }
  float d_far = norm3(fr);
  float pad;
  if (dof) {
    const float le = cam[15];
    float nr[3];
    for (int a = 0; a < 3; ++a)
      nr[a] = fmaxf(fmaxf(mn[a] - cam[a], cam[a] - mx[a]), 0.0f);
    float d_near = norm3(nr);
    float dmax = norm3(cam + 3) + norm3(cam + 6) + norm3(cam + 9);
    float s_lo = fmaxf(d_near - le, 0.0f);
    float s_hi = d_far + le;
    float maxfac = fmaxf(fabsf(1.0f - s_lo / (focus * dmax + le)),
                         fabsf(1.0f - s_hi / fmaxf(focus - le, 1e-6f)));
    pad = k * s_hi + le * maxfac + eps;
  } else {
    pad = k * d_far + eps;
  }
  float lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    float fp = 1e-3f * (mx[a] - mn[a]) + 1e-3f;
    lo[a] = mn[a] - pad - fp;
    hi[a] = mx[a] + pad + fp;
  }
  st4(dst, lo[0], lo[1], lo[2], static_cast<float>(s.skip[i]));
  st4(dst + 4, hi[0], hi[1], hi[2], static_cast<float>(s.first[i]));
  st4(dst + 8, static_cast<float>(s.count[i]), 0.0f, 0.0f, 0.0f);
}

// Leaf row j (slot j of the tree): the bounding sphere of primitive
// prim_index[j] - a sphere, or a triangle's centroid and farthest vertex
// (megakernel._bsphere_table) - and bs_hit's terms that do not depend on
// the pixel.
RT_DEV void mask_leaf_row(const MaskScene& s, const float* cam, int dof,
                          int j, float* dst) {
  const float eps = 1e-3f;
  const int id = s.pidx[j];
  float c[3], r;
  if (id < s.ns) {
    for (int a = 0; a < 3; ++a) c[a] = s.sph_center[3 * id + a];
    r = s.sph_radius[id];
  } else {
    const int t = 3 * (id - s.ns);
    const float third = static_cast<float>(1.0 / 3.0);
    float d0[3], d1[3], d2[3];
    for (int a = 0; a < 3; ++a) {
      float p0 = s.v0[t + a], p1 = s.v1[t + a], p2 = s.v2[t + a];
      c[a] = (p0 + p1 + p2) * third;
      d0[a] = p0 - c[a];
      d1[a] = p1 - c[a];
      d2[a] = p2 - c[a];
    }
    float q0 = d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2];
    float q1 = d1[0] * d1[0] + d1[1] * d1[1] + d1[2] * d1[2];
    float q2 = d2[0] * d2[0] + d2[1] * d2[1] + d2[2] * d2[2];
    r = sqrtf(fmaxf(fmaxf(q0, q1), q2));
  }
  float ocx = c[0] - cam[0], ocy = c[1] - cam[1], ocz = c[2] - cam[2];
  float oc2 = ocx * ocx + ocy * ocy + ocz * ocz;
  float dist = sqrtf(oc2);
  float base = r + (dist + r) * cam[12];
  float R = base + eps;  // bs_hit's R at dofl = 0
  st4(dst, ocx, ocy, ocz, oc2);
  st4(dst + 4, dist, r, dof ? base : R, dof ? 0.0f : R * R);
}

// bs_hit over a leaf row (a: oc.xyz, |oc|^2; b: dist, r, R or the base
// radius, R*R or 0).
RT_DEV bool leaf_hit(const CenterRay& c, F4 a, F4 b, int dof) {
  const float eps = 1e-3f;
  float g = a.x * c.dx + a.y * c.dy + a.z * c.dz;
  float R = b.z, R2 = b.w;
  if (dof) {
    float n_lo = b.x - b.y - c.le;
    float n_hi = b.x + b.y + c.le;
    float x_lo = n_lo * c.inv_sq * (n_lo >= 0.0f ? c.c_lo : c.c_hi);
    float x_hi = n_hi * c.inv_sq * c.c_hi;
    float dofl = c.le * (1.0f + c.k) *
                 fmaxf(fabsf(1.0f - x_lo), fabsf(1.0f - x_hi));
    R = b.z + dofl + eps;
    R2 = R * R;
  }
  return (a.w - g * g * c.inv_a <= R2) & (g >= -(R + c.ll) * c.sqa);
}

// The skip walk over the table's node rows (kNodeOnly: K6-stream, a boxed
// leaf marks the pixel; else K6, the leaf rows [first, first + count)),
// from shared memory or in place (kLdg).
template <bool kNodeOnly, bool kLdg>
RT_DEV bool table_walk(const CenterRay& c, const float* nodes, int n_nodes,
                       const float* leaves, int dof) {
  V3 iv = safe_inverse(V3{c.dx, c.dy, c.dz});
  bool hit = false;
  int cur = 0;
  for (int step = 0; step < n_nodes && cur < n_nodes && !hit; ++step) {
    const float* nd = nodes + kMaskNode * cur;
    F4 lo = ld4<kLdg>(nd);
    F4 hi = ld4<kLdg>(nd + 4);
    float t0x = (lo.x - c.ox) * iv.x;
    float t1x = (hi.x - c.ox) * iv.x;
    float t0y = (lo.y - c.oy) * iv.y;
    float t1y = (hi.y - c.oy) * iv.y;
    float t0z = (lo.z - c.oz) * iv.z;
    float t1z = (hi.z - c.oz) * iv.z;
    float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                       fmaxf(fminf(t0z, t1z), 0.0f));
    float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                      fmaxf(t0z, t1z));
    int skip = static_cast<int>(lo.w);
    if (!(near <= far)) {
      cur = skip;
      continue;
    }
    int cnt = static_cast<int>(ld<kLdg>(nd + 8));
    if (cnt == 0) {
      ++cur;
    } else if (kNodeOnly) {
      hit = true;
    } else {
      const float* row = leaves + kMaskLeaf * static_cast<int>(hi.w);
      for (int j = 0; j < cnt; ++j, row += kMaskLeaf)
        hit = hit | leaf_hit(c, ld4<kLdg>(row), ld4<kLdg>(row + 4), dof);
      cur = skip;
    }
  }
  return hit;
}

// The pixels of a persistent launch: warp w takes tiles w, w + n_warps,
// ... of kMaskTileW x kMaskTileH pixels (a static stride: no counter to
// zero before a launch of a few tens of microseconds).
template <bool kNodeOnly, bool kLdg>
RT_DEV void mask_tiles(uint8_t* out, int width, int height, float inv_w,
                       float inv_h, const float* cam, const float* table,
                       int n_nodes, int dof, const float* pln, int npl) {
  const int tiles_x = (width + kMaskTileW - 1) / kMaskTileW;
  const int n_tiles = tiles_x * ((height + kMaskTileH - 1) / kMaskTileH);
  const int thread = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  const int n_warps = static_cast<int>(gridDim.x * blockDim.x) / kWarpLanes;
  const int in_warp = static_cast<int>(threadIdx.x) % kWarpLanes;
  const float* leaves = table + kMaskNode * n_nodes;
  for (int t = thread / kWarpLanes; t < n_tiles; t += n_warps) {
    const int x0 = (t % tiles_x) * kMaskTileW;
    const int y0 = (t / tiles_x) * kMaskTileH;
    for (int l = in_warp; l < 32; l += kWarpLanes) {
      const int x = x0 + l % kMaskTileW, y = y0 + l / kMaskTileW;
      if (x >= width || y >= height) continue;
      const int p = y * width + x;
      CenterRay c = center_ray(p, width, inv_w, inv_h, cam);
      bool hit = table_walk<kNodeOnly, kLdg>(c, table, n_nodes, leaves, dof);
      hit = hit | planes_hit(c, pln, npl);
      out[p] = hit ? 1 : 0;
    }
  }
}

// Row i of the mask table: node rows [0, n_nodes), then leaf rows.
RT_DEV void mask_row(const MaskScene& s, const float* cam, float focus,
                     int dof, int i, float* tab) {
  if (i < s.n_nodes) {
    mask_node_row(s, cam, focus, dof, i, tab + kMaskNode * i);
  } else {
    const int j = i - s.n_nodes;
    mask_leaf_row(s, cam, dof, j, tab + kMaskNode * s.n_nodes + kMaskLeaf * j);
  }
}

// in_smem: the block builds the table in shared memory, else it reads the
// pre-pass's table in place.
template <bool kNodeOnly>
RT_DEV void mask_walk_body(uint8_t* out, int width, int height, float inv_w,
                           float inv_h, const float* cam, const float* table,
                           int in_smem, int dof, const float* pln, int npl,
                           float focus, const MaskScene& s) {
  extern __shared__ __align__(16) float smem[];
  if (in_smem) {
    for (int i = static_cast<int>(threadIdx.x); i < s.n_nodes + s.n_slots;
         i += static_cast<int>(blockDim.x))
      mask_row(s, cam, focus, dof, i, smem);
    __syncthreads();
    mask_tiles<kNodeOnly, false>(out, width, height, inv_w, inv_h, cam,
                                 smem, s.n_nodes, dof, pln, npl);
  } else {
    mask_tiles<kNodeOnly, true>(out, width, height, inv_w, inv_h, cam, table,
                                s.n_nodes, dof, pln, npl);
  }
}

}  // namespace rt

// The pre-pass of K6 and K6-stream past the shared-memory budget: the
// mask table in global memory, a row a thread.
extern "C" __global__ void __launch_bounds__(RT_MASK_THREADS)
rt_mask_table_kernel(float* __restrict__ tab, const float* __restrict__ cam,
                     float focus, int dof, rt::MaskScene s) {
  const int i = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (i < s.n_nodes + s.n_slots) rt::mask_row(s, cam, focus, dof, i, tab);
}

extern "C" __global__ void __launch_bounds__(RT_MASK_THREADS)
rt_pixel_mask_bvh_kernel(uint8_t* __restrict__ out, int width, int height,
                         float inv_w, float inv_h,
                         const float* __restrict__ cam,
                         const float* __restrict__ table, int in_smem,
                         int dof, const float* __restrict__ pln, int npl,
                         float focus, rt::MaskScene s) {
  rt::mask_walk_body<false>(out, width, height, inv_w, inv_h, cam, table,
                            in_smem, dof, pln, npl, focus, s);
}

extern "C" __global__ void __launch_bounds__(RT_MASK_THREADS)
rt_pixel_mask_stream_kernel(uint8_t* __restrict__ out, int width,
                            int height, float inv_w, float inv_h,
                            const float* __restrict__ cam,
                            const float* __restrict__ table, int in_smem,
                            int dof, const float* __restrict__ pln, int npl,
                            float focus, rt::MaskScene s) {
  rt::mask_walk_body<true>(out, width, height, inv_w, inv_h, cam, table,
                           in_smem, dof, pln, npl, focus, s);
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

// The scene's arrays that the mask table is built from (MaskScene), as
// the launchers take them: node_min, node_max, skip, first, count,
// n_nodes, prim_index, n_slots (0 for K6-stream: no leaf rows),
// sph_center, sph_radius, ns, v0, v1, v2.
#define RT_MASK_SCENE_ARGS                                                 \
  const float *node_min, const float *node_max, const int32_t *skip,       \
      const int32_t *first, const int32_t *count, int n_nodes,             \
      const int32_t *pidx, int n_slots, const float *sph_center,           \
      const float *sph_radius, int ns, const float *v0, const float *v1,   \
      const float *v2
#define RT_MASK_SCENE                                                      \
  rt::MaskScene {                                                          \
    node_min, node_max, skip, first, count, pidx, sph_center, sph_radius,  \
        v0, v1, v2, n_nodes, n_slots, ns                                   \
  }

// Launch the pre-pass on `stream`: the mask table into tab, from the
// camera row and the scene's arrays; focus: the focus distance, dof: depth
// of field on. Returns cudaGetLastError() after the launch.
extern "C" int rt_mask_table(float* tab, const float* cam, float focus,
                             int dof, RT_MASK_SCENE_ARGS, void* stream) {
  const int threads = RT_MASK_THREADS;
  const int rows = n_nodes + n_slots;
  if (rows > 0)
    rt_mask_table_kernel<<<(rows + threads - 1) / threads, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        tab, cam, focus, dof, RT_MASK_SCENE);
  return static_cast<int>(cudaGetLastError());
}

// Launch a walk, K6 or K6-stream: in_smem, each block builds the mask
// table (table_floats long) in its shared memory; else it reads the
// pre-pass's table at `table` in place.
template <class Kernel>
static int launch_mask_walk(Kernel kernel, uint8_t* out, int width,
                            int height, float inv_w, float inv_h,
                            const float* cam, const float* table,
                            int table_floats, int in_smem, int dof,
                            const float* pln, int npl, float focus,
                            const rt::MaskScene& s, void* stream) {
  const int threads = RT_MASK_THREADS;
  if (width > 0 && height > 0) {
    const int tiles = ((width + rt::kMaskTileW - 1) / rt::kMaskTileW) *
                      ((height + rt::kMaskTileH - 1) / rt::kMaskTileH);
    size_t smem = in_smem ? static_cast<size_t>(table_floats) * sizeof(float)
                          : 0;
    int blocks = rt::persistent_blocks(kernel, threads, smem, 32 * tiles);
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        out, width, height, inv_w, inv_h, cam, table, in_smem, dof, pln, npl,
        focus, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch K6 on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int rt_pixel_mask_bvh(uint8_t* out, int width, int height,
                                 float inv_w, float inv_h, const float* cam,
                                 const float* table, int table_floats,
                                 int in_smem, int dof, const float* pln,
                                 int npl, float focus, RT_MASK_SCENE_ARGS,
                                 void* stream) {
  return launch_mask_walk(rt_pixel_mask_bvh_kernel, out, width, height,
                          inv_w, inv_h, cam, table, table_floats, in_smem,
                          dof, pln, npl, focus, RT_MASK_SCENE, stream);
}

// Launch K6-stream on `stream`. Returns cudaGetLastError() after the
// launch.
extern "C" int rt_pixel_mask_stream(uint8_t* out, int width, int height,
                                    float inv_w, float inv_h,
                                    const float* cam, const float* table,
                                    int table_floats, int in_smem, int dof,
                                    const float* pln, int npl, float focus,
                                    RT_MASK_SCENE_ARGS, void* stream) {
  return launch_mask_walk(rt_pixel_mask_stream_kernel, out, width, height,
                          inv_w, inv_h, cam, table, table_floats, in_smem,
                          dof, pln, npl, focus, RT_MASK_SCENE, stream);
}
#endif
