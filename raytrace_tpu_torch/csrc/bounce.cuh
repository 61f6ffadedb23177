// The bounce loop of one lane, shared by K1 (trace_unroll.cu), K3+K4
// (trace_bvh.cu), K5 (trace_stream.cu) and K7 (trace_loop.cu).
//
// models/materials.py, models/textures.py, ops/shade.py and trace.py in
// scalar form: closest hit, smooth normal, material and texture, direct
// light with hard and soft shadows, scatter, accumulation. The extended
// body (K1-ext: smooth vertex normals, kinds 7-12, directional emission,
// textures, did_scatter) replaces the `advanced`, `textures` and `tri_vn`
// variants of raytrace_tpu/ops/megakernel.py:_make_kernel (:1921-1980,
// :2289, _tri_smooth_normal_g :349). It is one body for every scene:
// column counts and table sizes are run-time values, so one build serves
// flat and smooth, seven-kind and extended scenes alike.
//
// fast_mc (Run.rr_start, Run.tp_eps; the JAX kernel's :2392-2411) ends a
// lane whose throughput falls below the cutoff and, from rr_start on,
// plays Russian roulette after each scatter, boosting survivors by 1/q.
//
// The loop is resumable (K1-state, the start_bounce/end_bounce/
// return_state variant of _make_kernel, :278-300, state writes
// :2448-2459): it runs bounces [start_bounce, end_bounce) from a given
// throughput and alive flag, the radiance it returns is that segment's
// alone, and it can write the state the lane carries into bounce
// end_bounce - origin, direction, throughput and alive, 10 floats. Draws
// key off the absolute bounce, so segments sum to the whole trace. The
// resumable form is a second instantiation (kState) of each trace kernel,
// which a launch takes only when it passes state in or out: the state
// costs the whole loop registers (K1 about 20), and without it the kernels
// keep their occupancy.
//
// The geometry is a policy type with these members, so shading, scatter
// and accumulation exist once:
//
//   void  closest(V3 o, V3 d, float* t, int* kind, int* idx)
//         closest hit with t_min = 1e-3: kind 0 sphere, 1 triangle,
//         2 plane, 3 box, -1 miss; idx indexes that kind's rows
//   const float* sphere_row(int idx)    the hit sphere's center.xyz and
//         radius, its material at column kSphMat
//   const float* triangle_row(int idx)  the hit triangle's row in the
//         tri layout below
//   bool  occluded(V3 o, V3 d, float t_max)      the hard shadow test
//   float soft_unblocked(V3 p, V3 ld, float dist, const SoftRays& rays)
//         the number of the light's soft-shadow rays that nothing
//         blocks, as the sum of 1.0f over them
//   void  store_work(int32_t* out)               per-lane work counters
//
// Table layout (row-major float32, one flat array in this order):
//   sph [ns][5]   center.xyz, radius, mat
//   tri [nt][tri_cols]  13: v0.xyz, e1.xyz, e2.xyz, normal.xyz, mat (hit
//                 triangles: cube faces are left out, their boxes are the
//                 hit form); 22 in a smooth-shaded scene: + n0, n1, n2
//   pln [npl][7]  point.xyz, normal.xyz, mat
//   box [nb][7]   min.xyz, max.xyz, mat
//   lit [nl][7]   position.xyz, color.xyz, intensity
//   mat [nm][mat_cols]  14: kind, albedo.rgb, roughness, metallic,
//                 specular, ior, emit.rgb, eff_albedo.rgb; 19 with an
//                 extended kind: + aux_vec.xyz, aux_a, aux_b
//   tex [ntex][kTexCols]  texture bindings (textures.cuh)
//   aux [naux][3] the textures' aux rows
// followed, in bvh and stream modes, by the tree (bvh_walk.cuh). In
// stream mode ns = nt = 0: spheres and triangles are rows of the stream
// table (trace_stream.cu).
#pragma once

#include "common.cuh"
#include "textures.cuh"

namespace rt {

enum Kind {
  kLambertian = 0,
  kMetal = 1,
  kShiny = 2,
  kPerfectMirror = 3,
  kDiffuseLight = 6,
  kSubsurface = 7,
  kAnisotropic = 8,
  kClearcoat = 9,
  kSheen = 10,
  kEmission = 11,
  kMirror = 12
};

constexpr float kEmissionDirectional = 1.0f;

// The table sizes the wrapper passes (megakernel.prepare_trace).
struct Dims {
  int ns, nt, npl, nb, nl, nm, tri_cols, mat_cols, ntex, naux;
  int n_nodes, leaf_size, n_wide;  // bvh and stream modes only
};

struct Tables {
  const float* sph;
  const float* tri;
  const float* pln;
  const float* box;
  const float* lit;
  const float* mat;
  const float* tex;
  const float* aux;
  int ns, nt, npl, nb, nl, nm, tri_cols, mat_cols, ntex, naux;
};

// Floats of the scene tables (everything before the tree).
RT_HD int table_floats(const Dims& d) {
  return 5 * d.ns + d.tri_cols * d.nt + 7 * d.npl + 7 * d.nb + 7 * d.nl +
         d.mat_cols * d.nm + kTexCols * d.ntex + 3 * d.naux;
}

RT_DEV Tables make_tables(const float* base, const Dims& d) {
  Tables tb;
  tb.sph = base;
  tb.tri = tb.sph + 5 * d.ns;
  tb.pln = tb.tri + d.tri_cols * d.nt;
  tb.box = tb.pln + 7 * d.npl;
  tb.lit = tb.box + 7 * d.nb;
  tb.mat = tb.lit + 7 * d.nl;
  tb.tex = tb.mat + d.mat_cols * d.nm;
  tb.aux = tb.tex + kTexCols * d.ntex;
  tb.ns = d.ns;
  tb.nt = d.nt;
  tb.npl = d.npl;
  tb.nb = d.nb;
  tb.nl = d.nl;
  tb.nm = d.nm;
  tb.tri_cols = d.tri_cols;
  tb.mat_cols = d.mat_cols;
  tb.ntex = d.ntex;
  tb.naux = d.naux;
  return tb;
}

constexpr int kStateCols = 10;  // origin.xyz, direction.xyz, tp.xyz, alive

// One trace launch's lanes (flat arrays, lane i at 3*i, 10*i, ...) and
// run settings, as the wrapper passes them (megakernel.prepare_trace).
struct Lanes {
  const float* origin;     // (n,3)
  const float* direction;  // (n,3)
  const int32_t* pix;      // (n,)
  const int32_t* samp;     // (n,)
  const float* tp_in;      // (n,3) initial throughput, or null: ones
  const float* alive_in;   // (n,) initial alive flag 0/1, or null: alive
  float* radiance;         // (n,3) the segment's radiance
  float* state;            // (n,kStateCols) the state after, or null
  int32_t* counters;       // (n,n_counters) work counters, or null
  int n;
};

// fast_mc (trace.py, the JAX kernel's :2392-2411): rr_start is the first
// bounce of Russian roulette (-1: off), tp_eps the throughput below which
// a lane dies (0: off). soft_guard switches K1-guard (brute_force.cuh) on;
// only K1 reads it.
struct Run {
  int start_bounce, end_bounce, shadow_samples, soft, recursive;
  uint32_t seed;
  int rr_start;
  float tp_eps;
  int soft_guard;
};

// Does a launch resume or return lane state (the kState instantiation)?
RT_HD bool stateful(const Lanes& io, const Run& run) {
  return run.start_bounce != 0 || io.tp_in != nullptr ||
         io.alive_in != nullptr || io.state != nullptr;
}

RT_HD Lanes make_lanes(const float* origin, const float* direction,
                       const int32_t* pix, const int32_t* samp,
                       const float* tp_in, const float* alive_in,
                       float* radiance, float* state, int32_t* counters,
                       int n) {
  Lanes io;
  io.origin = origin;
  io.direction = direction;
  io.pix = pix;
  io.samp = samp;
  io.tp_in = tp_in;
  io.alive_in = alive_in;
  io.radiance = radiance;
  io.state = state;
  io.counters = counters;
  io.n = n;
  return io;
}

// The draws of one (lane, bounce, light) that make its soft-shadow rays.
struct SoftRays {
  uint32_t pix, samp, base, seed;
  int light, samples;
};

// Soft-shadow ray s: normalize(light_dir + 0.1 * unit_ball) with the draw
// site of rng.py:shadow_stream.
RT_DEV V3 soft_dir(const SoftRays& r, V3 ld, int s) {
  uint32_t stream = r.base + kShadowBase +
                    static_cast<uint32_t>(r.light * (r.samples + 1) + s);
  float b[3];
  unit_ball(r.pix, r.samp, stream, r.seed, b);
  return normalize3(V3{ld.x + 0.1f * b[0], ld.y + 0.1f * b[1],
                       ld.z + 0.1f * b[2]});
}

RT_DEV float tier_ambient(float m) {
  return m > 0.9f ? 0.05f : (m > 0.7f ? 0.07f : (m > 0.5f ? 0.08f : 0.1f));
}

RT_DEV float tier_diffuse(float m) {
  return m > 0.95f ? 0.05f
       : m > 0.9f  ? 0.08f
       : m > 0.8f  ? 0.12f
       : m > 0.7f  ? 0.15f
       : m > 0.5f  ? 0.2f
                   : 0.25f;
}

RT_DEV float tier_spec_power(float m) {
  return m > 0.9f ? 64.0f : (m > 0.8f ? 48.0f : 32.0f);
}

RT_DEV float tier_reflect(float m) {
  return m > 0.95f ? 0.85f
       : m > 0.9f  ? 0.8f
       : m > 0.8f  ? 0.75f
       : m > 0.7f  ? 0.7f
       : m > 0.5f  ? 0.6f
       : m > 0.2f  ? 0.4f
                   : 1.0f;
}

RT_DEV float pow5(float x) {
  float x2 = x * x;
  return x2 * x2 * x;
}

RT_DEV V3 reflect3(V3 d, V3 n) {
  float k = 2.0f * dot3(d, n);
  return V3{d.x - k * n.x, d.y - k * n.y, d.z - k * n.z};
}

// ops/intersect.py:_interp_tri_normal for the winning triangle row tr of
// a smooth-shaded scene: u, v recomputed by the hit test's expressions
// (f = 1/det), w*n0 + u*n1 + v*n2 scaled by 1/len (not divided by len).
RT_DEV V3 smooth_normal(const float* tr, V3 o, V3 d, V3 face) {
  float e1x = tr[3], e1y = tr[4], e1z = tr[5];
  float e2x = tr[6], e2y = tr[7], e2z = tr[8];
  float hx = d.y * e2z - d.z * e2y;
  float hy = d.z * e2x - d.x * e2z;
  float hz = d.x * e2y - d.y * e2x;
  float det = e1x * hx + e1y * hy + e1z * hz;
  if (!(fabsf(det) >= 1e-6f)) return face;
  float f = 1.0f / det;
  float sx = o.x - tr[0], sy = o.y - tr[1], sz = o.z - tr[2];
  float u = f * (sx * hx + sy * hy + sz * hz);
  float qx = sy * e1z - sz * e1y;
  float qy = sz * e1x - sx * e1z;
  float qz = sx * e1y - sy * e1x;
  float v = f * (d.x * qx + d.y * qy + d.z * qz);
  float w = 1.0f - u - v;
  V3 n{w * tr[13] + u * tr[16] + v * tr[19],
       w * tr[14] + u * tr[17] + v * tr[20],
       w * tr[15] + u * tr[18] + v * tr[21]};
  float ln = sqrtf(dot3(n, n));
  float inv = 1.0f / (ln > 0.0f ? ln : 1.0f);
  return V3{n.x * inv, n.y * inv, n.z * inv};
}

// The lambertian direction (also the clearcoat base's).
RT_DEV V3 lambert_dir(V3 n, V3 bl) {
  V3 l{n.x + bl.x, n.y + bl.y, n.z + bl.z};
  bool near_zero =
      fabsf(l.x) < 1e-8f && fabsf(l.y) < 1e-8f && fabsf(l.z) < 1e-8f;
  return normalize3(near_zero ? n : l);
}

// One lane through bounces [start_bounce, end_bounce) of the depth loop,
// from throughput tp if alive. rad gets the segment's radiance; state
// (optional) the lane's origin, direction, throughput and alive flag after
// it: a lane that misses or stops scattering keeps those of the bounce it
// died at. counters (optional): closest-hit rays, hard shadow rays, soft
// shadow rays, then the geometry's own work.
template <bool kState, class Geo>
RT_DEV void trace_lane(Geo& geo, const Tables& tb, V3 o, V3 d, V3 tp,
                       bool alive, uint32_t pix, uint32_t samp,
                       const Run& run, float* rad, float* state,
                       int32_t* counters) {
  const bool soft = run.soft != 0;
  const int shadow_samples = run.shadow_samples;
  const uint32_t seed = run.seed;
  V3 r{0.0f, 0.0f, 0.0f};
  int n_closest = 0, n_hard = 0, n_soft = 0;
  for (int bounce = kState ? run.start_bounce : 0;
       (!kState || alive) && bounce < run.end_bounce; ++bounce) {
    ++n_closest;
    float t;
    int kind_hit, idx;
    geo.closest(o, d, &t, &kind_hit, &idx);
    if (kind_hit < 0) {  // miss: the lane contributes nothing more
      alive = false;
      break;
    }

    V3 p{o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
    V3 out;
    int mid;
    if (kind_hit == 0) {
      const float* s = geo.sphere_row(idx);
      out = V3{(p.x - s[0]) / s[3], (p.y - s[1]) / s[3], (p.z - s[2]) / s[3]};
      mid = static_cast<int>(s[Geo::kSphMat]);
    } else if (kind_hit == 1) {
      const float* tr = geo.triangle_row(idx);
      out = V3{tr[9], tr[10], tr[11]};
      if (tb.tri_cols >= 22) out = smooth_normal(tr, o, d, out);
      mid = static_cast<int>(tr[12]);
    } else if (kind_hit == 2) {
      const float* pl = tb.pln + 7 * idx;
      out = V3{pl[3], pl[4], pl[5]};
      mid = static_cast<int>(pl[6]);
    } else {
      // Point-based box normal, NEGATED: the reference winds every cube
      // face inward, so exterior hits are back faces (this steers the
      // dielectric eta). Ties resolve x < y < z.
      const float* bx = tb.box + 7 * idx;
      float q[3], aq[3];
      for (int k = 0; k < 3; ++k) {
        float ctr = (bx[k] + bx[3 + k]) * 0.5f;
        float half = fmaxf((bx[3 + k] - bx[k]) * 0.5f, 1e-30f);
        float pk = k == 0 ? p.x : (k == 1 ? p.y : p.z);
        q[k] = (pk - ctr) / half;
        aq[k] = fabsf(q[k]);
      }
      int ax = 0;
      if (aq[1] > aq[ax]) ax = 1;
      if (aq[2] > aq[ax]) ax = 2;
      float sg = q[ax] > 0.0f ? 1.0f : (q[ax] < 0.0f ? -1.0f : q[ax]);
      out = V3{-((ax == 0 ? 1.0f : 0.0f) * sg),
               -((ax == 1 ? 1.0f : 0.0f) * sg),
               -((ax == 2 ? 1.0f : 0.0f) * sg)};
      mid = static_cast<int>(bx[6]);
    }
    bool front = dot3(d, out) < 0.0f;
    V3 n = front ? out : V3{-out.x, -out.y, -out.z};

    const float* m = tb.mat + tb.mat_cols * mid;
    int kind = static_cast<int>(m[0]);
    V3 alb{m[1], m[2], m[3]};
    float rough = m[4], metal = m[5], spec = m[6], ior = m[7];
    V3 emit{m[8], m[9], m[10]};
    V3 eff{m[11], m[12], m[13]};
    V3 av{0.0f, 0.0f, 0.0f};
    float aa = 0.0f, ab = 0.0f;
    if (tb.mat_cols >= 19) {
      av = V3{m[14], m[15], m[16]};
      aa = m[17];
      ab = m[18];
      if (kind == kEmission && aa == kEmissionDirectional) {
        float up = fmaxf(n.y, 0.0f);
        emit = V3{emit.x * up, emit.y * up, emit.z * up};
      }
    }
    if (tb.ntex > 0) apply_texture(tb.tex, tb.ntex, tb.aux, mid, p, &alb, &eff);

    // ---- direct light (ops/shade.py:direct_lighting) -------------------
    float amb = tier_ambient(metal);
    V3 dl{amb, amb, amb};
    float dstr = tier_diffuse(metal);
    float spow = tier_spec_power(metal);
    V3 view = normalize3(V3{-p.x, -p.y, -p.z});
    uint32_t base = static_cast<uint32_t>(bounce) * kStreamsPerBounce;
    for (int li = 0; li < tb.nl; ++li) {
      const float* L = tb.lit + 7 * li;
      V3 tl{L[0] - p.x, L[1] - p.y, L[2] - p.z};
      float dist = sqrtf(dot3(tl, tl));
      if (!(dist >= 1e-3f)) continue;  // light too close: skipped
      V3 ld = normalize3(tl);
      float cos_t = fmaxf(dot3(n, ld), 0.0f);
      // Every term below carries cos_t, so the shadow factor only matters
      // where cos_t > 0; elsewhere any finite value gives the same sum.
      float sf = 1.0f;
      if (cos_t > 0.0f) {
        ++n_hard;
        if (geo.occluded(p, ld, dist)) {
          sf = 0.0f;
        } else if (soft) {
          SoftRays rays{pix, samp, base, seed, li, shadow_samples};
          float unblocked = geo.soft_unblocked(p, ld, dist, rays);
          n_soft += shadow_samples;
          sf = unblocked / static_cast<float>(shadow_samples);
        }
      }
      float inten = cos_t * L[6] / (dist * dist);
      float dscale = dstr * inten * sf;
      V3 hd = normalize3(V3{ld.x + view.x, ld.y + view.y, ld.z + view.z});
      float spec_i = powf(fmaxf(dot3(n, hd), 0.0f), spow);
      float sscale = metal > 0.5f ? spec_i * inten * sf * metal * 3.0f : 0.0f;
      dl.x = dl.x + (eff.x * dscale + L[3] * sscale);
      dl.y = dl.y + (eff.y * dscale + L[4] * sscale);
      dl.z = dl.z + (eff.z * dscale + L[5] * sscale);
    }

    // ---- scatter (models/materials.py:scatter) -------------------------
    float ball[3], u4[4];
    unit_ball(pix, samp, base + kScatterBall, seed, ball);
    uniform4(pix, samp, base + kDielectric, seed, u4);
    float pick = u4[0];
    V3 bl{ball[0], ball[1], ball[2]};
    V3 refl = reflect3(d, n);
    float cos_raw = fabsf(dot3(d, n));
    float f0 = (ior - 1.0f) / (ior + 1.0f);
    f0 = f0 * f0;
    float fres = f0 + (1.0f - f0) * pow5(1.0f - cos_raw);
    V3 sdir, att;
    // DiffuseLight and Emission never scatter; a Mirror only while its
    // reflection stays above the surface.
    bool scatters = kind != kDiffuseLight && kind != kEmission;
    if (kind == kLambertian) {
      sdir = lambert_dir(n, bl);
      att = alb;
    } else if (kind == kMetal || kind == kShiny || kind == kPerfectMirror) {
      V3 pert = normalize3(V3{refl.x + bl.x * rough, refl.y + bl.y * rough,
                              refl.z + bl.z * rough});
      if (kind == kShiny) {
        sdir = rough > 0.0f ? pert : refl;
        float ss = 0.4f + spec * 0.4f;
        att = V3{fminf(alb.x * (1.0f - ss) + fres * ss, 1.0f),
                 fminf(alb.y * (1.0f - ss) + fres * ss, 1.0f),
                 fminf(alb.z * (1.0f - ss) + fres * ss, 1.0f)};
      } else {
        sdir = rough > 0.001f ? pert : refl;
        if (kind == kMetal) {
          float fs = 0.6f + metal * 0.4f;
          att = V3{fminf(fmaxf(alb.x * (1.0f - fs) + fres * fs, 0.0f), 1.0f),
                   fminf(fmaxf(alb.y * (1.0f - fs) + fres * fs, 0.0f), 1.0f),
                   fminf(fmaxf(alb.z * (1.0f - fs) + fres * fs, 0.0f), 1.0f)};
          if (metal > 0.8f) {
            float mfs = 0.4f + metal * 0.5f;
            att = V3{att.x * (1.0f - mfs) + fres * mfs,
                     att.y * (1.0f - mfs) + fres * mfs,
                     att.z * (1.0f - mfs) + fres * mfs};
          }
        } else {
          att = V3{alb.x * 0.1f + fres * 0.9f, alb.y * 0.1f + fres * 0.9f,
                   alb.z * 0.1f + fres * 0.9f};
        }
      }
    } else if (kind == kSubsurface) {
      sdir = V3{bl.x * ab, bl.y * ab, bl.z * ab};
      att = V3{alb.x * (av.x * aa), alb.y * (av.y * aa), alb.z * (av.z * aa)};
    } else if (kind == kAnisotropic) {
      float ar = rough * (1.0f + aa * dot3(av, n));
      sdir = ar > 0.0f ? normalize3(V3{refl.x + bl.x * ar, refl.y + bl.y * ar,
                                       refl.z + bl.z * ar})
                       : refl;
      att = alb;
    } else if (kind == kClearcoat) {
      sdir = lambert_dir(n, bl);
      att = V3{alb.x * (1.0f - aa) + fres * aa, alb.y * (1.0f - aa) + fres * aa,
               alb.z * (1.0f - aa) + fres * aa};
    } else if (kind == kSheen) {
      sdir = aa > 0.0f ? normalize3(V3{refl.x + bl.x * aa, refl.y + bl.y * aa,
                                       refl.z + bl.z * aa})
                       : refl;
      att = V3{av.x * (1.0f - ab) + alb.x * ab, av.y * (1.0f - ab) + alb.y * ab,
               av.z * (1.0f - ab) + alb.z * ab};
    } else if (kind == kMirror) {
      // the perturbed reflection is not normalised
      sdir = rough > 0.0f ? V3{refl.x + bl.x * rough, refl.y + bl.y * rough,
                               refl.z + bl.z * rough}
                          : refl;
      att = alb;
      scatters = dot3(sdir, n) > 0.0f;
    } else if (scatters) {
      // glass and dielectric
      V3 ud = normalize3(d);
      float ratio = front ? 1.0f / ior : ior;
      float udn = dot3(ud, n);
      float cos_i = fminf(-udn, 1.0f);
      float sin_i = sqrtf(fmaxf(1.0f - cos_i * cos_i, 0.0f));
      bool cannot = ratio * sin_i > 1.0f;
      float r0 = (1.0f - ratio) / (1.0f + ratio);
      r0 = r0 * r0;
      float refl_p = r0 + (1.0f - r0) * pow5(1.0f - cos_i);
      if (cannot || refl_p > pick) {
        sdir = reflect3(ud, n);
      } else {
        // Go's Refract with its total-internal-reflection fallback
        bool flip = udn > 0.0f;
        V3 n2 = flip ? V3{-n.x, -n.y, -n.z} : n;
        float eta2 = flip ? 1.0f / ratio : ratio;
        float cos2 = flip ? -udn : udn;
        float st2 = eta2 * eta2 * (1.0f - cos2 * cos2);
        if (st2 > 1.0f) {
          sdir = reflect3(ud, n2);
        } else {
          float ct2 = sqrtf(fmaxf(1.0f - st2, 0.0f));
          float k = eta2 * cos2 + ct2;
          sdir = V3{ud.x * eta2 - n2.x * k, ud.y * eta2 - n2.y * k,
                    ud.z * eta2 - n2.z * k};
        }
      }
      att = alb;
    }

    // ---- accumulate (trace.py) ------------------------------------------
    float w_r = tier_reflect(metal);
    float w_d = metal > 0.2f ? 1.0f - w_r : 1.0f;
    r.x = r.x + tp.x * emit.x;
    r.y = r.y + tp.y * emit.y;
    r.z = r.z + tp.z * emit.z;
    if (!scatters) {  // the path ends with emitted + direct, unweighted
      r.x = r.x + tp.x * dl.x;
      r.y = r.y + tp.y * dl.y;
      r.z = r.z + tp.z * dl.z;
      alive = false;
      break;
    }
    r.x = r.x + tp.x * dl.x * w_d;
    r.y = r.y + tp.y * dl.y * w_d;
    r.z = r.z + tp.z * dl.z * w_d;
    tp = V3{tp.x * att.x * w_r, tp.y * att.y * w_r, tp.z * att.z * w_r};
    o = p;
    d = sdir;
    if (run.recursive == 0) {
      alive = false;
      break;
    }
    // ---- fast_mc: throughput cutoff, then Russian roulette -------------
    // A lane that dies here keeps the unboosted throughput in its state.
    // The survivors' boost multiplies by 1/q, as the JAX kernel does (the
    // JAX engine divides, which can round one ulp apart).
    float tmax = fmaxf(tp.x, fmaxf(tp.y, tp.z));
    if (run.tp_eps > 0.0f && !(tmax >= run.tp_eps)) {
      alive = false;
      break;
    }
    if (run.rr_start >= 0 && bounce >= run.rr_start) {
      float q = fminf(fmaxf(tmax, 0.05f), 1.0f);
      float u4rr[4];
      uniform4(pix, samp, base + kRussianRoulette, seed, u4rr);
      if (u4rr[0] >= q) {
        alive = false;
        break;
      }
      float inv_q = 1.0f / q;
      tp = V3{tp.x * inv_q, tp.y * inv_q, tp.z * inv_q};
    }
  }
  rad[0] = r.x;
  rad[1] = r.y;
  rad[2] = r.z;
  if (kState && state != nullptr) {
    state[0] = o.x;
    state[1] = o.y;
    state[2] = o.z;
    state[3] = d.x;
    state[4] = d.y;
    state[5] = d.z;
    state[6] = tp.x;
    state[7] = tp.y;
    state[8] = tp.z;
    state[9] = alive ? 1.0f : 0.0f;
  }
  if (counters != nullptr) {
    counters[0] = n_closest;
    counters[1] = n_hard;
    counters[2] = n_soft;
    geo.store_work(counters + 3);
  }
}

// Lane `lane` of a launch: reads its inputs, runs trace_lane, writes its
// outputs (the entry of every trace kernel).
template <bool kState, class Geo>
RT_DEV void run_lane(Geo& geo, const Tables& tb, const Lanes& io,
                     const Run& run, int lane, int n_counters) {
  const float* o = io.origin + 3 * lane;
  const float* d = io.direction + 3 * lane;
  V3 tp{1.0f, 1.0f, 1.0f};
  bool alive = true;
  if (kState) {
    if (io.tp_in != nullptr) {
      const float* t = io.tp_in + 3 * lane;
      tp = V3{t[0], t[1], t[2]};
    }
    alive = io.alive_in == nullptr || io.alive_in[lane] > 0.0f;
  }
  trace_lane<kState>(geo, tb, V3{o[0], o[1], o[2]}, V3{d[0], d[1], d[2]},
             tp, alive,
             static_cast<uint32_t>(io.pix[lane]),
             static_cast<uint32_t>(io.samp[lane]), run, io.radiance + 3 * lane,
             io.state == nullptr ? nullptr : io.state + kStateCols * lane,
             io.counters == nullptr ? nullptr
                                    : io.counters + n_counters * lane);
}

}  // namespace rt
