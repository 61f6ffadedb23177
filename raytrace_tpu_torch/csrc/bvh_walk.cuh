// K3 and K4: the scene-BVH walks of the bounce loop in bvh mode.
//
// Replaces, in raytrace_tpu/ops/megakernel.py:_make_kernel(mode="bvh"),
// the closest-hit walks closest_fn_binary (:954) and closest_fn_wide
// (:1000) and the hard-shadow walk occl_test_fn (:1104) - K3 - and the
// fused soft-shadow walk soft_fused_fn (:1308, _node_delta :1401) - K4.
// Plain versions: bvh.py:traverse_closest / traverse_any, as
// ops/intersect.py and ops/shade.py call them (one walk per ray).
//
// One thread walks for one lane. The walks are stackless: the tree is in
// DFS order with skip pointers, a box hit moves the cursor to the next
// node and a miss to the node's skip pointer, so the cursor only grows and
// a walk visits each node at most once (the node loops are bounded by the
// node count, the leaf loops by the leaf size). The closest-hit walk is
// the binary walk of traverse_closest in the same node order with the same
// slab and primitive arithmetic and the same strict t < t_best, so it
// takes the same hit, ties included. (The TPU kernel's default is a 4-wide
// stack walk, which differs only on exact ties; the 4-wide layout is later
// performance work.) Boxes and planes are unbounded or few and stay brute
// force around the walk, in the order of intersect.py:_closest_hit_accel.
//
// K4 makes one walk for all soft-shadow rays of a (lane, light): node
// slabs are tested once, with the central light direction, against boxes
// grown by 0.102 * min(farthest-corner distance, light distance) (a
// jittered ray deviates from the central one by at most 0.1002 per unit
// length), near-clamped at 0.9949 * t_min. That visits a superset of the
// leaves of every per-ray walk, and each boxed leaf tests every ray not
// yet blocked with exactly the per-ray arithmetic, so every verdict is
// that of its own walk. Blocked rays are bits of a 64-bit mask; the walk
// ends when the mask is full. Past 64 samples the fused walk runs once
// per block of 64 rays, so any sample count takes the same verdicts.
//
// The tree and the sphere and triangle tables stay in global memory
// (4096 triangles x 13 floats outgrow the 48 KB of static shared memory)
// and are read through the read-only cache.
//
// Node table: [n_nodes][9] min.xyz, max.xyz, skip, first, count (floats,
// exact integers); prim_index: [P] floats, a primitive id per leaf slot
// (id < ns: sphere, else triangle id - ns; triangles past the hit table,
// the cube faces, are skipped: their boxes are the hit form). The smooth
// normal of a triangle winner (K1-ext) needs only its index, which the
// closest-hit walk returns.
#pragma once

#include "bounce.cuh"

namespace rt {

constexpr int kBvhCounters = 10;  // 3 from trace_lane + 7 below

struct Bvh {
  const float* nodes;
  const float* pidx;
  int n_nodes;
  int leaf_size;
};

struct NodeBox {
  V3 lo, hi;
  int skip, first, count;
};

RT_DEV NodeBox load_node(const Bvh& bvh, int i) {
  const float* nd = bvh.nodes + 9 * i;
  NodeBox b;
  b.lo = V3{ldg(nd), ldg(nd + 1), ldg(nd + 2)};
  b.hi = V3{ldg(nd + 3), ldg(nd + 4), ldg(nd + 5)};
  b.skip = static_cast<int>(ldg(nd + 6));
  b.first = static_cast<int>(ldg(nd + 7));
  b.count = static_cast<int>(ldg(nd + 8));
  return b;
}

// bvh.py:_box_hit - the slab interval clamped to [t_min, t_max].
RT_DEV bool slab_hit(const NodeBox& b, V3 o, V3 inv, float t_max) {
  float t0x = (b.lo.x - o.x) * inv.x, t1x = (b.hi.x - o.x) * inv.x;
  float t0y = (b.lo.y - o.y) * inv.y, t1y = (b.hi.y - o.y) * inv.y;
  float t0z = (b.lo.z - o.z) * inv.z, t1z = (b.hi.z - o.z) * inv.z;
  float near = fmaxf(fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z)), kTMin);
  float far = fminf(fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fmaxf(t0z, t1z)), t_max);
  return near <= far;
}

struct BvhGeo {
  const Tables& tb;
  Bvh bvh;
  // Work: [0] node slab tests and [1] sphere and [2] triangle tests of the
  // closest-hit and hard-shadow walks; [3] node slab tests and [4] (ray,
  // sphere) and [5] (ray, triangle) tests of the fused soft walks; [6]
  // brute-force plane and box tests.
  int work[7];

  RT_DEV void closest(V3 o, V3 d, float* t_out, int* kind_out,
                      int* idx_out) {
    float a = dot3(d, d);
    float inv_a = 1.0f / a;
    V3 inv = safe_inverse(d);
    // boxes first: their winner seeds the walk
    float t_box = kBig;
    int b_idx = 0;
    for (int j = 0; j < tb.nb; ++j) {
      ++work[6];
      float tj = box_t(o, inv, tb.box + 7 * j, kBig);
      if (tj < t_box) { t_box = tj; b_idx = j; }
    }
    float t_best = t_box;
    int best = -1;
    int cur = 0;
    for (int step = 0; step < bvh.n_nodes && cur < bvh.n_nodes; ++step) {
      ++work[0];
      NodeBox b = load_node(bvh, cur);
      if (!slab_hit(b, o, inv, t_best)) {
        cur = b.skip;
        continue;
      }
      if (b.count == 0) {
        ++cur;
        continue;
      }
      for (int j = 0; j < bvh.leaf_size && j < b.count; ++j) {
        int pid = static_cast<int>(ldg(bvh.pidx + b.first + j));
        float tj;
        if (pid < tb.ns) {
          ++work[1];
          float s[4];
          load_row<true>(tb.sph + 5 * pid, 4, s);
          tj = sphere_t(o, d, a, inv_a, s, t_best);
        } else {
          int ti = pid - tb.ns;
          if (ti >= tb.nt) continue;  // a cube face
          ++work[2];
          float tr[9];
          load_row<true>(tb.tri + tb.tri_cols * ti, 9, tr);
          tj = triangle_t(o, d, tr, t_best);
        }
        if (tj < t_best) { t_best = tj; best = pid; }
      }
      cur = b.skip;
    }
    float t = kBig;
    int kind = -1, idx = 0;
    if (best >= 0) {
      t = t_best;
      kind = best < tb.ns ? 0 : 1;
      idx = best < tb.ns ? best : best - tb.ns;
    }
    if (tb.nb > 0 && t_box < t) { t = t_box; kind = 3; idx = b_idx; }
    float t_pl = kBig;
    int p_idx = 0;
    for (int j = 0; j < tb.npl; ++j) {
      ++work[6];
      float tj = plane_t(o, d, tb.pln + 7 * j, kBig);
      if (tj < t_pl) { t_pl = tj; p_idx = j; }
    }
    if (t_pl < t) { t = t_pl; kind = 2; idx = p_idx; }
    *t_out = t;
    *kind_out = kind;
    *idx_out = idx;
  }

  // Any hit in [t_min, t_max]: boxes, planes, then the walk; stops at the
  // first blocker, which leaves the verdict unchanged.
  RT_DEV bool occluded(V3 o, V3 d, float t_max) {
    V3 inv = safe_inverse(d);
    for (int j = 0; j < tb.nb; ++j) {
      ++work[6];
      if (box_blocked(o, inv, tb.box + 7 * j, t_max)) return true;
    }
    for (int j = 0; j < tb.npl; ++j) {
      ++work[6];
      if (plane_t(o, d, tb.pln + 7 * j, t_max) < kBig) return true;
    }
    float a = dot3(d, d);
    float inv_a = 1.0f / a;
    int cur = 0;
    for (int step = 0; step < bvh.n_nodes && cur < bvh.n_nodes; ++step) {
      ++work[0];
      NodeBox b = load_node(bvh, cur);
      if (!slab_hit(b, o, inv, t_max)) {
        cur = b.skip;
        continue;
      }
      if (b.count == 0) {
        ++cur;
        continue;
      }
      for (int j = 0; j < bvh.leaf_size && j < b.count; ++j) {
        int pid = static_cast<int>(ldg(bvh.pidx + b.first + j));
        if (pid < tb.ns) {
          ++work[1];
          float s[4];
          load_row<true>(tb.sph + 5 * pid, 4, s);
          if (sphere_t(o, d, a, inv_a, s, t_max) < kBig) return true;
        } else {
          int ti = pid - tb.ns;
          if (ti >= tb.nt) continue;
          ++work[2];
          float tr[9];
          load_row<true>(tb.tri + tb.tri_cols * ti, 9, tr);
          if (triangle_blocked(o, d, tr, t_max)) return true;
        }
      }
      cur = b.skip;
    }
    return false;
  }

  // K4: all soft-shadow rays of one (lane, light), in one walk for each
  // block of up to 64 of them.
  RT_DEV float soft_unblocked(V3 p, V3 ld, float dist, const SoftRays& rays) {
    int blocked = 0;
    for (int s0 = 0; s0 < rays.samples; s0 += 64)
      blocked += soft_block(p, ld, dist, rays, s0,
                            rays.samples - s0 < 64 ? rays.samples - s0 : 64);
    return static_cast<float>(rays.samples - blocked);
  }

  // The fused walk for soft rays [s0, s0 + S): how many are blocked.
  RT_DEV int soft_block(V3 p, V3 ld, float dist, const SoftRays& rays,
                        int s0, int S) {
    float sx[64], sy[64], sz[64], sa[64], sia[64];
    for (int s = 0; s < S; ++s) {
      V3 sd = soft_dir(rays, ld, s0 + s);
      sx[s] = sd.x;
      sy[s] = sd.y;
      sz[s] = sd.z;
      sa[s] = dot3(sd, sd);
      sia[s] = 1.0f / sa[s];
    }
    const uint64_t full =
        S >= 64 ? ~0ull : ((1ull << static_cast<uint64_t>(S)) - 1ull);
    uint64_t bm = 0;  // bit s: ray s0 + s is blocked
    // planes and boxes outside the tree, every ray
    for (int s = 0; s < S; ++s) {
      V3 sd{sx[s], sy[s], sz[s]};
      bool hit = false;
      for (int j = 0; j < tb.npl && !hit; ++j) {
        ++work[6];
        hit = plane_t(p, sd, tb.pln + 7 * j, dist) < kBig;
      }
      if (!hit && tb.nb > 0) {
        V3 inv = safe_inverse(sd);
        for (int j = 0; j < tb.nb && !hit; ++j) {
          ++work[6];
          hit = box_blocked(p, inv, tb.box + 7 * j, dist);
        }
      }
      if (hit) bm |= 1ull << s;
    }
    const float cone = 0.102f;
    const float tminc = 0.9949f * kTMin;
    V3 iv = safe_inverse(ld);
    int cur = 0;
    for (int step = 0; step < bvh.n_nodes && cur < bvh.n_nodes; ++step) {
      if (bm == full) break;
      ++work[3];
      NodeBox b = load_node(bvh, cur);
      // _node_delta: the cone's reach at the node's farthest corner
      float fx = fmaxf((b.lo.x - p.x) * (b.lo.x - p.x),
                       (b.hi.x - p.x) * (b.hi.x - p.x));
      float fy = fmaxf((b.lo.y - p.y) * (b.lo.y - p.y),
                       (b.hi.y - p.y) * (b.hi.y - p.y));
      float fz = fmaxf((b.lo.z - p.z) * (b.lo.z - p.z),
                       (b.hi.z - p.z) * (b.hi.z - p.z));
      float delta = cone * fminf(sqrtf(fx + fy + fz), dist);
      float t0x = (b.lo.x - delta - p.x) * iv.x;
      float t1x = (b.hi.x + delta - p.x) * iv.x;
      float t0y = (b.lo.y - delta - p.y) * iv.y;
      float t1y = (b.hi.y + delta - p.y) * iv.y;
      float t0z = (b.lo.z - delta - p.z) * iv.z;
      float t1z = (b.hi.z + delta - p.z) * iv.z;
      float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fmaxf(fminf(t0z, t1z), tminc));
      float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                        fminf(fmaxf(t0z, t1z), dist));
      if (!(near <= far)) {
        cur = b.skip;
        continue;
      }
      if (b.count == 0) {
        ++cur;
        continue;
      }
      for (int j = 0; j < bvh.leaf_size && j < b.count && bm != full; ++j) {
        int pid = static_cast<int>(ldg(bvh.pidx + b.first + j));
        if (pid < tb.ns) {
          float s[4];
          load_row<true>(tb.sph + 5 * pid, 4, s);
          for (int r = 0; r < S; ++r) {
            if (bm >> r & 1ull) continue;
            ++work[4];
            if (sphere_t(p, V3{sx[r], sy[r], sz[r]}, sa[r], sia[r], s,
                         dist) < kBig)
              bm |= 1ull << r;
          }
        } else {
          int ti = pid - tb.ns;
          if (ti >= tb.nt) continue;
          float tr[9];
          load_row<true>(tb.tri + tb.tri_cols * ti, 9, tr);
          TriPre T = tri_pre(p, tr);
          for (int r = 0; r < S; ++r) {
            if (bm >> r & 1ull) continue;
            ++work[5];
            if (tri_blocked_pre(T, V3{sx[r], sy[r], sz[r]}, dist))
              bm |= 1ull << r;
          }
        }
      }
      cur = b.skip;
    }
    return popc64(bm);
  }

  RT_DEV void store_work(int32_t* out) {
    for (int k = 0; k < 7; ++k) out[k] = work[k];
  }
};

}  // namespace rt
