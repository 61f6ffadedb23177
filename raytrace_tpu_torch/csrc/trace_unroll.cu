// K1: the bounce megakernel for scenes of at most 96 primitives.
//
// Replaces raytrace_tpu/ops/megakernel.py:trace_pallas (:2987) built by
// _make_kernel(mode="unroll") (:278; kernel :772, closest_hit :370,
// _box_closest :454, occl_precompute :499, any_hit_pre :550, bounce body
// :1876). Semantics are those of the plain version, trace.py:trace, which
// is checked lane for lane against the JAX engine.
//
// Design for Hopper. One thread traces one lane through the whole depth
// loop; lanes are flat (B,) arrays. The scene tables (<= 96 primitives,
// 14-column material rows, lights; a few KB) are copied once per block into
// shared memory, where every thread of a warp reads the same row at the
// same time (a broadcast). Primitive loops take their counts at run time -
// the TPU kernel's full unroll was an artifact of Mosaic's compile-time
// shapes. The bounce, light and soft-shadow loops have static upper bounds
// (RT_MAX_*; the wrapper refuses larger settings) and no loop waits on
// data. Occlusion tests stop at the first blocker, which leaves the verdict
// unchanged. What bounds it: operations, not bytes - each lane reads 32
// bytes and writes 12, but a bounce runs up to 1 + lights * (1 + samples)
// rays against every primitive. Divergence between lanes of a warp (a glass
// lane bouncing 50 times beside a dead one) is the cost this simple design
// accepts; survivor re-compaction is later work.
//
// Table layout (row-major float32, one buffer, in this order):
//   sph [ns][5]  center.xyz, radius, mat
//   tri [nt][13] v0.xyz, e1.xyz, e2.xyz, normal.xyz, mat (hit triangles:
//                cube faces are left out, their boxes are the hit form)
//   pln [npl][7] point.xyz, normal.xyz, mat
//   box [nb][7]  min.xyz, max.xyz, mat
//   lit [nl][7]  position.xyz, color.xyz, intensity
//   mat [nm][14] kind, albedo.rgb, roughness, metallic, specular, ior,
//                emit.rgb, eff_albedo.rgb
#include "common.cuh"

#define RT_MAX_DEPTH 64
#define RT_MAX_LIGHTS 16
#define RT_MAX_SHADOW_SAMPLES 64

namespace rt {

constexpr int kCounters = 5;  // per-lane work counters (optional output)

enum Kind {
  kLambertian = 0,
  kMetal = 1,
  kShiny = 2,
  kPerfectMirror = 3,
  kDiffuseLight = 6
};

struct Tables {
  const float* sph;
  const float* tri;
  const float* pln;
  const float* box;
  const float* lit;
  const float* mat;
  int ns, nt, npl, nb, nl, nm;
};

// Any hit in [t_min, t_max]; stops at the first blocker (same verdict).
// Adds the primitive tests it ran to tests[0] (spheres and planes) and
// tests[1] (triangles and boxes), for operation counts.
RT_DEV bool occluded(const Tables& tb, V3 o, V3 d, float t_max,
                     int tests[2]) {
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

// One lane: models/materials.py, ops/shade.py and trace.py in scalar form.
RT_DEV void trace_lane(const Tables& tb, V3 o, V3 d, uint32_t pix,
                       uint32_t samp, int max_depth, int shadow_samples,
                       bool soft, bool recursive, uint32_t seed, float* rad,
                       int* counters) {
  V3 tp{1.0f, 1.0f, 1.0f};
  V3 r{0.0f, 0.0f, 0.0f};
  // work done, for operation counts: closest-hit rays, hard shadow rays,
  // soft shadow rays, occlusion tests (spheres+planes, triangles+boxes)
  int n_closest = 0, n_hard = 0, n_soft = 0, tests[2] = {0, 0};
  for (int bounce = 0; bounce < RT_MAX_DEPTH; ++bounce) {
    if (bounce >= max_depth) break;
    ++n_closest;
    // ---- closest hit: first minimum over [sph, tri, pln, box] --------
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
    if (kind_hit < 0) break;  // miss: the lane contributes nothing more

    V3 p{o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
    V3 out;
    int mid;
    if (kind_hit == 0) {
      const float* s = tb.sph + 5 * idx;
      out = V3{(p.x - s[0]) / s[3], (p.y - s[1]) / s[3], (p.z - s[2]) / s[3]};
      mid = static_cast<int>(s[4]);
    } else if (kind_hit == 1) {
      const float* tr = tb.tri + 13 * idx;
      out = V3{tr[9], tr[10], tr[11]};
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

    const float* m = tb.mat + 14 * mid;
    int kind = static_cast<int>(m[0]);
    V3 alb{m[1], m[2], m[3]};
    float rough = m[4], metal = m[5], spec = m[6], ior = m[7];
    V3 emit{m[8], m[9], m[10]};
    V3 eff{m[11], m[12], m[13]};

    // ---- direct light (ops/shade.py:direct_lighting) -------------------
    float amb = tier_ambient(metal);
    V3 dl{amb, amb, amb};
    float dstr = tier_diffuse(metal);
    float spow = tier_spec_power(metal);
    V3 view = normalize3(V3{-p.x, -p.y, -p.z});
    uint32_t base = static_cast<uint32_t>(bounce) * kStreamsPerBounce;
    for (int li = 0; li < RT_MAX_LIGHTS; ++li) {
      if (li >= tb.nl) break;
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
        if (occluded(tb, p, ld, dist, tests)) {
          sf = 0.0f;
        } else if (soft) {
          float unblocked = 0.0f;
          for (int s = 0; s < RT_MAX_SHADOW_SAMPLES; ++s) {
            if (s >= shadow_samples) break;
            uint32_t stream = base + kShadowBase +
                              static_cast<uint32_t>(li * (shadow_samples + 1) + s);
            float b[3];
            unit_ball(pix, samp, stream, seed, b);
            V3 sd = normalize3(V3{ld.x + 0.1f * b[0], ld.y + 0.1f * b[1],
                                  ld.z + 0.1f * b[2]});
            ++n_soft;
            unblocked += occluded(tb, p, sd, dist, tests) ? 0.0f : 1.0f;
          }
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
    if (kind == kLambertian) {
      V3 l{n.x + bl.x, n.y + bl.y, n.z + bl.z};
      bool near_zero = fabsf(l.x) < 1e-8f && fabsf(l.y) < 1e-8f &&
                       fabsf(l.z) < 1e-8f;
      sdir = normalize3(near_zero ? n : l);
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
    } else {
      // glass and dielectric (a DiffuseLight ends below; its dir is unused)
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
    if (kind == kDiffuseLight) {
      r.x = r.x + tp.x * dl.x;
      r.y = r.y + tp.y * dl.y;
      r.z = r.z + tp.z * dl.z;
      break;
    }
    r.x = r.x + tp.x * dl.x * w_d;
    r.y = r.y + tp.y * dl.y * w_d;
    r.z = r.z + tp.z * dl.z * w_d;
    tp = V3{tp.x * att.x * w_r, tp.y * att.y * w_r, tp.z * att.z * w_r};
    o = p;
    d = sdir;
    if (!recursive) break;
  }
  rad[0] = r.x;
  rad[1] = r.y;
  rad[2] = r.z;
  if (counters != nullptr) {
    counters[0] = n_closest;
    counters[1] = n_hard;
    counters[2] = n_soft;
    counters[3] = tests[0];
    counters[4] = tests[1];
  }
}

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
  const float* o = origin + 3 * lane;
  const float* d = direction + 3 * lane;
  rt::trace_lane(tb, rt::V3{o[0], o[1], o[2]}, rt::V3{d[0], d[1], d[2]},
                 static_cast<uint32_t>(pix[lane]),
                 static_cast<uint32_t>(samp[lane]), max_depth, shadow_samples,
                 soft != 0, recursive != 0, seed, radiance + 3 * lane,
                 counters == nullptr ? nullptr
                                     : counters + rt::kCounters * lane);
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
