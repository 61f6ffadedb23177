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
// K2 tests the bounding spheres in primitive order and the planes; a
// pixel's test ends at its first hit (the bits are ors, so the order
// changes no bit).
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
// On Hopper: persistent blocks of 1024 threads (common.cuh), one an SM
// on most scenes, each of which builds in its prologue what every pixel
// reads, from the scene's own tensors, in its dynamic shared memory.
// - The camera row: thread 0 runs mask_camera (below) into the first
//   kCamPad floats; the host does not build it.
// - The mask table: for K6 and K6-stream a 48-byte node row [lo.xyz,
//   skip, hi.xyz, first, count, 0, 0, 0] a tree node with the grown slab
//   (lo, hi), then for K6 one 32-byte leaf row a leaf slot, in slot order
//   (prim_index resolved); K2's table is the leaf rows alone, one a
//   primitive in primitive order (spheres, then every triangle, cube
//   faces included), built by the same code through an identity
//   prim_index. A leaf row holds what bs_hit computes before it looks at
//   the pixel: [oc.xyz, |oc|^2, dist, r, R, R*R] with R the finished
//   radius, or with depth of field [oc.xyz, |oc|^2, dist, r, r + (dist +
//   r)*k, 0]. The operations are those of bs_hit and of the wrapper's
//   plain versions (megakernel.mask_table_plain, k2_table_plain), in the
//   same order, so every test gives the same bits as the per-pixel form.
//   Rows are built a row a thread.
// - Each warp then takes a tile of 8x4 pixels at a time, by a static
//   stride over the tiles, so the 32 center rays of a warp stay close. A
//   node test is two 16-byte loads (and a third at a boxed node); a leaf
//   test is a dot product and two compares (plus the thin-lens slack,
//   compiled into K2's DoF entry only).
// - Past the wrapper's budget (megakernel.MASK_SMEM_BYTES, the camera
//   row's slot included): K6 and K6-stream (the past-cap grid's 393 KB
//   table) take the pre-pass (rt_mask_table_kernel, a row a thread),
//   which writes the table to global memory, and the walk reads it in
//   place, through the read-only cache, by the same code (kLdg). K2 (a
//   loop-mode scene of more than 7,261 primitives) builds its rows a
//   chunk at a time: each thread owns its pixels, skips those an earlier
//   chunk marked, and tests the rest against the chunk.
// Why so: on the H100 a separate pre-pass launch before every walk took
// about 3 us however small the table, and copying the table into each of
// several 256-thread blocks an SM meant some 200 KB of L2 reads an SM;
// building it per block in 1024-thread blocks was the fastest of the
// forms tried side by side (PERF.md: 256, 512 and 1024 threads, with the
// pre-pass or the prologue, 8x4 or 32x1 tiles, at most 2 blocks an SM,
// the table in place). K2 had been one thread a pixel in a grid of
// 256-thread blocks, recomputing every (pixel, primitive)'s offset,
// distance and radius and testing every primitive. What bounds the
// kernels: operations - the center ray, slab tests, leaf tests and planes
// a pixel - and the prologue (the camera row's serial chain, then the
// rows) on short walks.
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
// The camera row (cam, 18 floats; rt::mask_camera builds it from the
// scene's camera tensors in each block's prologue): [origin.xyz, A.xyz,
// B.xyz, C.xyz, k, kp, ll, Le, c_lo, c_hi] - direction = A + u*B + v*C.
// Planes: the scene's pl_point (Np,3) and pl_normal (Np,3), read as they
// lie.
#include "common.cuh"

namespace rt {

constexpr int kCamPad = 20;  // the camera row's 18 floats at the front
                             // of shared memory, padded to 16 bytes

struct CenterRay {
  float ox, oy, oz, dx, dy, dz, k, inv_a, sqa, inv_sq;
  float kp, ll, le, c_lo, c_hi;  // thin-lens terms (0, 0 and kp = k: none)
};

// Pixel (x, y)'s center ray.
RT_DEV CenterRay center_ray(int x, int y, float inv_w, float inv_h,
                            const float* cam) {
  float u = (static_cast<float>(x) + 0.5f) * inv_w;
  float v = (static_cast<float>(y) + 0.5f) * inv_h;
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

// The planes' interval test (pln_hit), every plane: pl_point and
// pl_normal (Np,3).
RT_DEV bool planes_hit(const CenterRay& c, const float* pp, const float* pn,
                       int npl) {
  const float eps = 1e-3f;
  bool hit = false;
  for (int j = 0; j < npl; ++j) {
    const float* p = pp + 3 * j;
    const float* n = pn + 3 * j;
    float denom = c.dx * n[0] + c.dy * n[1] + c.dz * n[2];
    float num = (p[0] - c.ox) * n[0] + (p[1] - c.oy) * n[1] +
                (p[2] - c.oz) * n[2];
    hit = hit | (fabsf(denom) <= c.kp + eps) | (num * denom > 0.0f) |
          (fabsf(num) <= c.ll + eps);
  }
  return hit;
}

// ------------------------------------------------------ the camera row ----

// What the camera row is built from: the scene's camera tensors
// (scene.Camera) as they lie on the card, and the launch's settings.
struct MaskCam {
  const float* position;  // (3,)
  const float* look_at;   // (3,)
  const float* up;        // (3,)
  const float* fov;       // () degrees
  const float* aspect;    // ()
  int go;                 // 1: the go camera, 0: the look-at camera
  int width, height;
  int dof;                // thin-lens depth of field on
  float lens;             // lens radius (float32)
  float focus;            // max(focus distance, 1e-6) (float32)
};

RT_DEV float norm3(const float* v) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// torch.clamp(v, min=lo) on the card: NaN passes.
RT_DEV float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

RT_DEV void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// The camera row that megakernel._mask_camera computes with PyTorch's CUDA
// operators (over _affine_camera, camera.lookat_basis and _cone_half_sin),
// operation for operation in their order and rounding, so that the row
// equals theirs bit for bit. Two of those operators round otherwise than
// the CPU's: a division by a Python number is a multiply by its float32
// reciprocal (x / 2.0 is exact either way; |B| / width and |C| / height
// are not: k may differ from the CPU row's by an ulp), and tan is the
// card's tanf. 1.0 / t is t's reciprocal, 1.0 / t correctly rounded.
RT_DEV void mask_camera(const MaskCam& m, float* row) {
  float A[3], B[3], C[3];
  const float asp = m.aspect[0];
  if (m.go) {
    // vp_w = 2*aspect; B = [vp_w, 0, 0], C = [0, 2, 0];
    // A = -B/2 - C/2 - [0, 0, 1]
    const float vp_w = asp * 2.0f;
    const float b[3] = {vp_w, 0.0f, 0.0f}, c[3] = {0.0f, 2.0f, 0.0f};
    const float z[3] = {0.0f, 0.0f, 1.0f};
    for (int a = 0; a < 3; ++a) {
      B[a] = b[a];
      C[a] = c[a];
      A[a] = (-b[a] * 0.5f - c[a] * 0.5f) - z[a];
    }
  } else {
    float f[3], r[3], u[3];
    for (int a = 0; a < 3; ++a) f[a] = m.look_at[a] - m.position[a];
    const float nf = norm3(f);
    for (int a = 0; a < 3; ++a) f[a] = f[a] / nf;
    cross3(f, m.up, r);
    const float nr = norm3(r);
    for (int a = 0; a < 3; ++a) r[a] = r[a] / nr;
    cross3(r, f, u);
    // fov * (pi / 180): the Python number rounded to float32
    const float theta =
        m.fov[0] * static_cast<float>(3.141592653589793 / 180.0);
    const float half_h = tanf(theta * 0.5f);
    const float half_w = asp * half_h;
    for (int a = 0; a < 3; ++a) {
      A[a] = (f[a] - half_w * r[a]) - half_h * u[a];
      B[a] = (half_w * 2.0f) * r[a];
      C[a] = (half_h * 2.0f) * u[a];
    }
  }
  // the jitter cone: 0.5 * (|B| / width + |C| / height)
  const float inv_w = 1.0f / static_cast<float>(m.width);
  const float inv_h = 1.0f / static_cast<float>(m.height);
  const float k = (norm3(B) * inv_w + norm3(C) * inv_h) * 0.5f;
  float kp = k, ll = k * 0.0f, le = k * 0.0f, c_lo = le, c_hi = le;
  if (m.dof) {
    const float* w = m.up;
    le = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2] + 1.0f) * m.lens;
    kp = k + le / clamp_min(m.focus - le, 1e-6f);
    ll = le * (kp + 1.0f);
    c_lo = 1.0f / ((k + 1.0f) * m.focus + le);
    c_hi = 1.0f / clamp_min((1.0f - k) * m.focus - le, 1e-6f);
  }
  for (int a = 0; a < 3; ++a) {
    row[a] = m.position[a];
    row[3 + a] = A[a];
    row[6 + a] = B[a];
    row[9 + a] = C[a];
  }
  row[12] = k;
  row[13] = kp;
  row[14] = ll;
  row[15] = le;
  row[16] = c_lo;
  row[17] = c_hi;
}

}  // namespace rt

// ---------------------------------------- K2, K6, K6-stream on Hopper ----

// The threads of a mask block.
#define RT_MASK_THREADS 1024

namespace rt {

constexpr int kMaskNode = 12;  // floats of a mask-table node row
constexpr int kMaskLeaf = 8;   // floats of a mask-table leaf row
constexpr int kMaskTileW = 8;  // a warp's tile of pixels: 8 x 4
constexpr int kMaskTileH = 32 / kMaskTileW;

// What a mask table is built from: the scene's arrays as it holds them.
struct MaskScene {
  const float* node_min;    // (N,3)
  const float* node_max;    // (N,3)
  const int32_t* skip;      // (N,)
  const int32_t* first;     // (N,)
  const int32_t* count;     // (N,)
  const int32_t* pidx;      // (P,) prim_index; null: the identity (K2)
  const float* sph_center;  // (Ns,3)
  const float* sph_radius;  // (Ns,)
  const float* v0;          // (Nt,3) triangle vertices, cube faces too
  const float* v1;
  const float* v2;
  int n_nodes, n_slots, ns;  // n_slots 0: no leaf rows (K6-stream)
};

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

// What a table row is built from that does not depend on the camera (so
// that K2 can gather it while the camera row is being built): a node's
// box and ints, or a primitive's bounding sphere (center in lo, radius in
// hi[0]).
struct RowIn {
  float lo[3], hi[3];
  int skip, first, count;
};

RT_DEV RowIn node_in(const MaskScene& s, int i) {
  RowIn in;
  for (int a = 0; a < 3; ++a) {
    in.lo[a] = s.node_min[3 * i + a];
    in.hi[a] = s.node_max[3 * i + a];
  }
  in.skip = s.skip[i];
  in.first = s.first[i];
  in.count = s.count[i];
  return in;
}

// The bounding sphere of primitive prim_index[j] (K6: slot j of the tree;
// K2: primitive j itself): a sphere, or a triangle's centroid and
// farthest vertex (megakernel._bsphere_table).
RT_DEV RowIn leaf_in(const MaskScene& s, int j) {
  RowIn in;
  const int id = s.pidx ? s.pidx[j] : j;
  float* c = in.lo;
  if (id < s.ns) {
    for (int a = 0; a < 3; ++a) c[a] = s.sph_center[3 * id + a];
    in.hi[0] = s.sph_radius[id];
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
    in.hi[0] = sqrtf(fmaxf(fmaxf(q0, q1), q2));
  }
  return in;
}

// Row i's inputs: node rows [0, n_nodes), then leaf rows.
RT_DEV RowIn row_in(const MaskScene& s, int i) {
  return i < s.n_nodes ? node_in(s, i) : leaf_in(s, i - s.n_nodes);
}

// A node row: the slab grown by the cone pad at its farthest corner,
// k*d_far + eps, or with depth of field k*s_hi + Le*maxfac + eps, plus
// the fp slack 1e-3*extent + 1e-3 (megakernel._mask_tree).
RT_DEV void mask_node_row(const RowIn& in, const float* cam, float focus,
                          int dof, float* dst) {
  const float eps = 1e-3f;
  const float k = cam[12];
  const float *mn = in.lo, *mx = in.hi;
  float fr[3];
  for (int a = 0; a < 3; ++a)
    fr[a] = fmaxf(fabsf(mn[a] - cam[a]), fabsf(mx[a] - cam[a]));
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
  st4(dst, lo[0], lo[1], lo[2], static_cast<float>(in.skip));
  st4(dst + 4, hi[0], hi[1], hi[2], static_cast<float>(in.first));
  st4(dst + 8, static_cast<float>(in.count), 0.0f, 0.0f, 0.0f);
}

// A leaf row: a bounding sphere and bs_hit's terms that do not depend on
// the pixel.
RT_DEV void mask_leaf_row(const RowIn& in, const float* cam, int dof,
                          float* dst) {
  const float eps = 1e-3f;
  const float* c = in.lo;
  const float r = in.hi[0];
  float ocx = c[0] - cam[0], ocy = c[1] - cam[1], ocz = c[2] - cam[2];
  float oc2 = ocx * ocx + ocy * ocy + ocz * ocz;
  float dist = sqrtf(oc2);
  float base = r + (dist + r) * cam[12];
  float R = base + eps;  // bs_hit's R at dofl = 0
  st4(dst, ocx, ocy, ocz, oc2);
  st4(dst + 4, dist, r, dof ? base : R, dof ? 0.0f : R * R);
}

// The cone-inflated bounding-sphere test (bs_hit) over a leaf row (a:
// oc.xyz, |oc|^2; b: dist, r, R or the base radius, R*R or 0), with the
// thin-lens slack when dof.
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
// zero before a launch of a few microseconds), the tile's coordinates
// stepped without a division a tile; f(x, y, p) gives pixel p = y*width
// + x its bit.
template <class F>
RT_DEV void for_mask_pixels(int width, int height, F&& f) {
  const int tiles_x = (width + kMaskTileW - 1) / kMaskTileW;
  const int tiles_y = (height + kMaskTileH - 1) / kMaskTileH;
  const int thread = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  const int n_warps = static_cast<int>(gridDim.x * blockDim.x) / kWarpLanes;
  const int in_warp = static_cast<int>(threadIdx.x) % kWarpLanes;
  const int first = thread / kWarpLanes;
  const int step_x = n_warps % tiles_x, step_y = n_warps / tiles_x;
  for (int tx = first % tiles_x, ty = first / tiles_x; ty < tiles_y;) {
    const int x0 = tx * kMaskTileW, y0 = ty * kMaskTileH;
    for (int l = in_warp; l < 32; l += kWarpLanes) {
      const int x = x0 + l % kMaskTileW, y = y0 + l / kMaskTileW;
      if (x < width && y < height) f(x, y, y * width + x);
    }
    tx += step_x;   // tile t + n_warps
    ty += step_y;
    if (tx >= tiles_x) {
      tx -= tiles_x;
      ++ty;
    }
  }
}

// K6 and K6-stream's pixels: the walk, then the planes.
template <bool kNodeOnly, bool kLdg>
RT_DEV void mask_tiles(uint8_t* out, int width, int height, float inv_w,
                       float inv_h, const float* cam, const float* table,
                       int n_nodes, int dof, const float* pp,
                       const float* pn, int npl) {
  const float* leaves = table + kMaskNode * n_nodes;
  for_mask_pixels(width, height, [&](int x, int y, int p) {
    CenterRay c = center_ray(x, y, inv_w, inv_h, cam);
    bool hit = table_walk<kNodeOnly, kLdg>(c, table, n_nodes, leaves, dof);
    hit = hit | planes_hit(c, pp, pn, npl);
    out[p] = hit ? 1 : 0;
  });
}

// Row i of the mask table, from its inputs: node rows [0, n_nodes), then
// leaf rows.
RT_DEV void mask_row(const MaskScene& s, const RowIn& in, const float* cam,
                     float focus, int dof, int i, float* tab) {
  if (i < s.n_nodes)
    mask_node_row(in, cam, focus, dof, tab + kMaskNode * i);
  else
    mask_leaf_row(in, cam, dof,
                  tab + kMaskNode * s.n_nodes + kMaskLeaf * (i - s.n_nodes));
}

// The prologue of every mask block: thread 0 builds the camera row in the
// first kCamPad floats of shared memory. Returns them; the table, where a
// block builds one, follows them.
RT_DEV float* camera_prologue(const MaskCam& m) {
  extern __shared__ __align__(16) float smem[];
  if (threadIdx.x == 0) mask_camera(m, smem);
  __syncthreads();
  return smem;
}

// in_smem: the block builds the table in shared memory, else it reads the
// pre-pass's table in place.
template <bool kNodeOnly>
RT_DEV void mask_walk_body(uint8_t* out, int width, int height, float inv_w,
                           float inv_h, const MaskCam& m, const float* table,
                           int in_smem, const float* pp, const float* pn,
                           int npl, const MaskScene& s) {
  const float* cam = camera_prologue(m);
  if (in_smem) {
    float* tab = const_cast<float*>(cam) + kCamPad;
    for (int i = static_cast<int>(threadIdx.x); i < s.n_nodes + s.n_slots;
         i += static_cast<int>(blockDim.x))
      mask_row(s, row_in(s, i), cam, m.focus, m.dof, i, tab);
    __syncthreads();
    mask_tiles<kNodeOnly, false>(out, width, height, inv_w, inv_h, cam, tab,
                                 s.n_nodes, m.dof, pp, pn, npl);
  } else {
    mask_tiles<kNodeOnly, true>(out, width, height, inv_w, inv_h, cam, table,
                                s.n_nodes, m.dof, pp, pn, npl);
  }
}

// K2's pixels against leaf rows [0, n) in shared memory: the planes first
// (on the first chunk), then the rows in primitive order, stopping at the
// first hit; a pixel already marked by an earlier chunk is skipped.
template <bool kDof>
RT_DEV void k2_tiles(uint8_t* out, int width, int height, float inv_w,
                     float inv_h, const float* cam, const float* rows, int n,
                     bool first, const float* pp, const float* pn, int npl) {
  for_mask_pixels(width, height, [&](int x, int y, int p) {
    if (!first && out[p]) return;
    CenterRay c = center_ray(x, y, inv_w, inv_h, cam);
    bool hit = first && planes_hit(c, pp, pn, npl);
    const float* row = rows;
    for (int j = 0; j < n && !hit; ++j, row += kMaskLeaf)
      hit = leaf_hit(c, ld4<false>(row), ld4<false>(row + 4), kDof);
    out[p] = hit ? 1 : 0;
  });
}

// K2: each block builds its leaf rows (the scene's bounding spheres in
// primitive order) in shared memory, chunk_rows at a time, and runs its
// pixels over each chunk. A thread gathers the inputs of its first row of
// a chunk (leaf_in) before the barrier that precedes the chunk - the
// camera row's, or the end of the last chunk - so that those loads
// overlap it: about 1 us a launch on the H100 (PERF.md). (K6 and
// K6-stream, whose rows are many, ran no faster so.)
template <bool kDof>
RT_DEV void k2_body(uint8_t* out, int width, int height, float inv_w,
                    float inv_h, const MaskCam& m, int chunk_rows,
                    const float* pp, const float* pn, int npl,
                    const MaskScene& s) {
  const int n = s.n_slots;
  const int t = static_cast<int>(threadIdx.x);
  RowIn first{};
  if (t < n && t < chunk_rows) first = leaf_in(s, t);
  const float* cam = camera_prologue(m);
  float* rows = const_cast<float*>(cam) + kCamPad;
  const int step = static_cast<int>(blockDim.x);
  for (int c0 = 0;; c0 += chunk_rows) {
    const int m_rows = n - c0 < chunk_rows ? n - c0 : chunk_rows;
    if (t < m_rows) mask_leaf_row(first, cam, kDof, rows + kMaskLeaf * t);
    for (int i = t + step; i < m_rows; i += step)
      mask_leaf_row(leaf_in(s, c0 + i), cam, kDof, rows + kMaskLeaf * i);
    __syncthreads();
    k2_tiles<kDof>(out, width, height, inv_w, inv_h, cam, rows, m_rows,
                   c0 == 0, pp, pn, npl);
    if (c0 + chunk_rows >= n) break;
    if (t < chunk_rows && c0 + chunk_rows + t < n)
      first = leaf_in(s, c0 + chunk_rows + t);
    __syncthreads();  // every pixel done with this chunk's rows
  }
}

}  // namespace rt

// K2, pinhole and with depth of field (the thin-lens slack compiled in
// only here).
#define RT_K2_PARAMS                                                       \
  uint8_t *__restrict__ out, int width, int height, float inv_w,           \
      float inv_h, rt::MaskCam m, int chunk_rows,                          \
      const float *__restrict__ pl_point,                                  \
      const float *__restrict__ pl_normal, int npl, rt::MaskScene s
#define RT_K2_ARGS                                                         \
  out, width, height, inv_w, inv_h, m, chunk_rows, pl_point, pl_normal,    \
      npl, s

extern "C" __global__ void __launch_bounds__(RT_MASK_THREADS)
rt_pixel_mask_kernel(RT_K2_PARAMS) {
  rt::k2_body<false>(RT_K2_ARGS);
}

extern "C" __global__ void __launch_bounds__(RT_MASK_THREADS)
rt_pixel_mask_dof_kernel(RT_K2_PARAMS) {
  rt::k2_body<true>(RT_K2_ARGS);
}

// The pre-pass of K6 and K6-stream past the shared-memory budget: the
// mask table in global memory, a row a thread.
extern "C" __global__ void __launch_bounds__(RT_MASK_THREADS)
rt_mask_table_kernel(float* __restrict__ tab, rt::MaskCam m,
                     rt::MaskScene s) {
  const float* cam = rt::camera_prologue(m);
  const int i = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (i < s.n_nodes + s.n_slots)
    rt::mask_row(s, rt::row_in(s, i), cam, m.focus, m.dof, i, tab);
}

#define RT_WALK_PARAMS                                                     \
  uint8_t *__restrict__ out, int width, int height, float inv_w,           \
      float inv_h, rt::MaskCam m, const float *__restrict__ table,         \
      int in_smem, const float *__restrict__ pl_point,                     \
      const float *__restrict__ pl_normal, int npl, rt::MaskScene s
#define RT_WALK_ARGS                                                       \
  out, width, height, inv_w, inv_h, m, table, in_smem, pl_point,           \
      pl_normal, npl, s

extern "C" __global__ void __launch_bounds__(RT_MASK_THREADS)
rt_pixel_mask_bvh_kernel(RT_WALK_PARAMS) {
  rt::mask_walk_body<false>(RT_WALK_ARGS);
}

extern "C" __global__ void __launch_bounds__(RT_MASK_THREADS)
rt_pixel_mask_stream_kernel(RT_WALK_PARAMS) {
  rt::mask_walk_body<true>(RT_WALK_ARGS);
}

// The camera row alone, for the checks: one thread writes it to row.
extern "C" __global__ void rt_mask_camera_kernel(float* __restrict__ row,
                                                 rt::MaskCam m) {
  if (blockIdx.x == 0 && threadIdx.x == 0) rt::mask_camera(m, row);
}

#ifndef RT_HOST_EMULATION
// The camera of a mask launch (MaskCam) as the launchers take it: the
// scene's position, look_at, up, fov and aspect_ratio tensors, go, dof,
// lens radius, focus distance.
#define RT_MASK_CAM_ARGS                                                   \
  const float *position, const float *look_at, const float *up,            \
      const float *fov, const float *aspect, int go, int dof, float lens,  \
      float focus
#define RT_MASK_CAM                                                        \
  rt::MaskCam {                                                            \
    position, look_at, up, fov, aspect, go, width, height, dof, lens, focus \
  }

// The scene's arrays that a mask table is built from (MaskScene), as
// the launchers take them: node_min, node_max, skip, first, count,
// n_nodes, prim_index, n_slots (0 for K6-stream: no leaf rows),
// sph_center, sph_radius, ns, v0, v1, v2. K2 passes no tree (n_nodes 0,
// prim_index null: the identity) and n_slots = Ns + Nt.
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

// Launch the camera row into row (18 floats) on `stream`, one thread.
// Returns cudaGetLastError() after the launch.
extern "C" int rt_mask_camera(float* row, int width, int height,
                              RT_MASK_CAM_ARGS, void* stream) {
  rt_mask_camera_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      row, RT_MASK_CAM);
  return static_cast<int>(cudaGetLastError());
}

// Launch the pre-pass on `stream`: the mask table into tab, from the
// camera and the scene's arrays. Returns cudaGetLastError() after the
// launch.
extern "C" int rt_mask_table(float* tab, int width, int height,
                             RT_MASK_CAM_ARGS, RT_MASK_SCENE_ARGS,
                             void* stream) {
  const int threads = RT_MASK_THREADS;
  const int rows = n_nodes + n_slots;
  if (rows > 0)
    rt_mask_table_kernel<<<(rows + threads - 1) / threads, threads,
                           sizeof(float) * rt::kCamPad,
                           static_cast<cudaStream_t>(stream)>>>(
        tab, RT_MASK_CAM, RT_MASK_SCENE);
  return static_cast<int>(cudaGetLastError());
}

// A persistent mask launch of `kernel` over the pixels' tiles, with
// `floats` of dynamic shared memory besides the camera row.
template <class Kernel, class... Args>
static int launch_mask(Kernel kernel, int width, int height, size_t floats,
                       void* stream, Args... args) {
  if (width > 0 && height > 0) {
    const int tiles = ((width + rt::kMaskTileW - 1) / rt::kMaskTileW) *
                      ((height + rt::kMaskTileH - 1) / rt::kMaskTileH);
    const size_t smem = sizeof(float) * (rt::kCamPad + floats);
    const int blocks =
        rt::persistent_blocks(kernel, RT_MASK_THREADS, smem, 32 * tiles);
    kernel<<<blocks, RT_MASK_THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch K2 on `stream`: each block builds the leaf rows in its shared
// memory, chunk_rows at a time. Returns cudaGetLastError() after the
// launch.
extern "C" int rt_pixel_mask(uint8_t* out, int width, int height,
                             float inv_w, float inv_h, RT_MASK_CAM_ARGS,
                             int chunk_rows, const float* pl_point,
                             const float* pl_normal, int npl,
                             RT_MASK_SCENE_ARGS, void* stream) {
  const rt::MaskCam m = RT_MASK_CAM;
  const rt::MaskScene s = RT_MASK_SCENE;
  const int rows = n_slots < chunk_rows ? n_slots : chunk_rows;
  return launch_mask(dof ? rt_pixel_mask_dof_kernel : rt_pixel_mask_kernel,
                     width, height, static_cast<size_t>(rt::kMaskLeaf) * rows,
                     stream, out, width, height, inv_w, inv_h, m, chunk_rows,
                     pl_point, pl_normal, npl, s);
}

// Launch a walk, K6 or K6-stream: in_smem, each block builds the mask
// table (table_floats long) in its shared memory; else it reads the
// pre-pass's table at `table` in place.
template <class Kernel>
static int launch_mask_walk(Kernel kernel, uint8_t* out, int width,
                            int height, float inv_w, float inv_h,
                            const rt::MaskCam& m, const float* table,
                            int table_floats, int in_smem,
                            const float* pl_point, const float* pl_normal,
                            int npl, const rt::MaskScene& s, void* stream) {
  return launch_mask(kernel, width, height,
                     in_smem ? static_cast<size_t>(table_floats) : 0, stream,
                     out, width, height, inv_w, inv_h, m, table, in_smem,
                     pl_point, pl_normal, npl, s);
}

// Launch K6 on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int rt_pixel_mask_bvh(uint8_t* out, int width, int height,
                                 float inv_w, float inv_h, RT_MASK_CAM_ARGS,
                                 const float* table, int table_floats,
                                 int in_smem, const float* pl_point,
                                 const float* pl_normal, int npl,
                                 RT_MASK_SCENE_ARGS, void* stream) {
  return launch_mask_walk(rt_pixel_mask_bvh_kernel, out, width, height,
                          inv_w, inv_h, RT_MASK_CAM, table, table_floats,
                          in_smem, pl_point, pl_normal, npl, RT_MASK_SCENE,
                          stream);
}

// Launch K6-stream on `stream`. Returns cudaGetLastError() after the
// launch.
extern "C" int rt_pixel_mask_stream(uint8_t* out, int width, int height,
                                    float inv_w, float inv_h,
                                    RT_MASK_CAM_ARGS, const float* table,
                                    int table_floats, int in_smem,
                                    const float* pl_point,
                                    const float* pl_normal, int npl,
                                    RT_MASK_SCENE_ARGS, void* stream) {
  return launch_mask_walk(rt_pixel_mask_stream_kernel, out, width, height,
                          inv_w, inv_h, RT_MASK_CAM, table, table_floats,
                          in_smem, pl_point, pl_normal, npl, RT_MASK_SCENE,
                          stream);
}
#endif
