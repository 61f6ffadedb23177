// K3 and K4: the scene-BVH walks of the bounce loop in bvh mode, and over
// the stream table's leaf rows in stream mode (K5, trace_stream.cu).
//
// Replaces, in raytrace_tpu/ops/megakernel.py:_make_kernel(mode="bvh"),
// the closest-hit walks closest_fn_binary (:954) and closest_fn_wide
// (:1000) and the hard-shadow walk occl_test_fn (:1104) - K3 - and the
// fused soft-shadow walk soft_fused_fn (:1308, _node_delta :1401) - K4.
// Plain versions: bvh.py:traverse_closest_wide (traverse_closest in the
// binary order) and traverse_any, as ops/intersect.py and ops/shade.py
// call them (one walk per ray).
//
// One thread walks for one lane, in one of two orders (walk_tree below).
// The 4-wide stack walk - K3-wide, the JAX kernel's default, replacing
// closest_fn_wide (:1000) and the wide bodies of the shadow walks (:1258,
// :1621) - pops a wide node off the lane's stack, slab-tests its 4 slots
// against the state it popped with, runs the boxed leaf slots in slot
// order and pushes the boxed inner slots in slot order. The binary skip
// walk, the fallback, takes the tree in DFS order with skip pointers: a
// box hit moves the cursor to the next node and a miss to the node's skip
// pointer, so a walk visits each node at most once. Which one a scene
// takes is bvh.py:wide_walk's choice, the JAX kernel's: the 4-wide table
// is then in the tables and n_wide > 0. The closest-hit walk has
// the slab and primitive arithmetic and the strict t < t_best of
// bvh.py:traverse_closest_wide (traverse_closest for the binary order), so
// it takes the same hit, ties included; the two orders differ only in
// which of two hits at exactly equal t wins. The shadow walks' verdicts do
// not depend on the order. Boxes and planes are unbounded or few and stay
// brute force around the walk, in the order of
// intersect.py:_closest_hit_accel.
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
// per block of 64 rays, so any sample count takes the same verdicts. Each
// soft ray is packed as {x, y, z, |d|^2} and 1/|d|^2: two local loads a
// (row, ray) test instead of five.
//
// Node table: [n_nodes][9] min.xyz, max.xyz, skip, first, count (floats,
// exact integers); 4-wide table: [n_wide][4][9] min.xyz, max.xyz, child,
// first, count per slot (bvh.py:widen4). The walks read them, and the
// leaf rows, through the read-only cache (kLdg) from global memory, or
// plainly from shared memory (K3+K4's walk table, trace_bvh.cu). Where a
// leaf's primitives come from is the Leaves policy of the walks:
//   WalkLeaves (bvh mode, K3+K4): the rows of the walk table
//     (megakernel.pack_walk_table), one 16-byte aligned row of 12 floats
//     per leaf slot, prim_index resolved when it was packed;
//   RowLeaves (stream mode, K5, stream_walk.cuh): the unified rows of the
//     stream table, one per leaf slot, read in place (trace_stream.cu).
// The hit's attributes (the smooth normal of a triangle winner, K1-ext,
// included) are read from the scene tables (bvh mode) or the stream row
// (stream mode) by the id that the closest-hit walk returns.
#pragma once

#include "bounce.cuh"

namespace rt {

constexpr int kBvhCounters = 10;  // 3 from trace_lane + 7 below
constexpr int kWideStack = 64;    // bvh.py:WIDE_STACK

struct Bvh {
  const float* nodes;
  int n_nodes;
  int leaf_size;
  const float* wide;  // the 4-wide table, when n_wide > 0
  int n_wide;
};

// The tables after the scene tables (bvh and stream modes): the node
// table, then the 4-wide table; returns what follows them.
RT_DEV const float* bvh_tables(const float* tables, const Dims& dims,
                               Bvh* bvh) {
  bvh->nodes = tables + table_floats(dims);
  bvh->n_nodes = dims.n_nodes;
  bvh->leaf_size = dims.leaf_size;
  bvh->wide = bvh->nodes + 9 * dims.n_nodes;
  bvh->n_wide = dims.n_wide;
  return bvh->wide + 36 * dims.n_wide;
}

// K3+K4's walk table (megakernel.pack_walk_table): the tree that the walks
// take - the 4-wide table when n_wide > 0, else the binary node table,
// padded to a multiple of 4 floats - then the leaf rows; returns the
// rows.
RT_DEV const float* walk_tables(const float* walk, const Dims& dims,
                                Bvh* bvh) {
  bvh->nodes = walk;
  bvh->n_nodes = dims.n_nodes;
  bvh->leaf_size = dims.leaf_size;
  bvh->wide = walk;
  bvh->n_wide = dims.n_wide;
  int n = dims.n_wide > 0 ? 36 * dims.n_wide : 9 * dims.n_nodes;
  return walk + ((n + 3) & ~3);
}

// Leaf slots as rows of the walk table: 12 floats a slot, 16-byte
// aligned - v0.xyz, e1.xyz, e2.xyz (a sphere: center.xyz, radius, then
// zeros), tag (0 sphere, 1 triangle, 2 cube face), id (into the sphere or
// the triangle table), 0 - read from shared memory, or in place from
// global memory (kLdg). The hit's attributes come from the scene tables.
constexpr int kWalkRow = 12;

template <bool kLdg>
struct WalkLeaves {
  static constexpr int kSphMat = 4;  // sph row: center.xyz, radius, mat
  const Tables& tb;
  const float* rows;

  // The primitive of leaf slot `slot`: 0 sphere (*row: center.xyz,
  // radius), 1 triangle (*row: v0, e1, e2), -1 none (a cube face: its box
  // is the hit form); *id indexes sphere_row/triangle_row. *row is the
  // slot's row.
  RT_DEV int prim(int slot, int* id, const float** row) const {
    const float* r = rows + kWalkRow * slot;
    F4 c = ld4<kLdg>(r + 8);  // e2.z, tag, id, 0
    *id = static_cast<int>(c.z);
    *row = r;
    return c.y == 0.0f ? 0 : (c.y == 1.0f ? 1 : -1);
  }
  RT_DEV const float* sphere_row(int i) const { return tb.sph + 5 * i; }
  RT_DEV const float* triangle_row(int i) const {
    return tb.tri + tb.tri_cols * i;
  }
};

// The first n floats (4: a sphere, 9: a triangle) of a leaf slot's row
// (Leaves::prim's *row).
template <bool kLdg, class Leaves>
RT_DEV void leaf_row(const Leaves&, const float* row, int n, float* dst) {
  load_row<kLdg>(row, n, dst);
}

// The same from a walk-table row, in 16-byte loads.
template <bool kLdg, bool kRowsLdg>
RT_DEV void leaf_row(const WalkLeaves<kRowsLdg>&, const float* row, int n,
                     float* dst) {
  F4 a = ld4<kLdg>(row);
  dst[0] = a.x;
  dst[1] = a.y;
  dst[2] = a.z;
  dst[3] = a.w;
  if (n > 4) {
    F4 b = ld4<kLdg>(row + 4);
    dst[4] = b.x;
    dst[5] = b.y;
    dst[6] = b.z;
    dst[7] = b.w;
    dst[8] = ld4<kLdg>(row + 8).x;
  }
}

struct NodeBox {
  V3 lo, hi;
  int skip, first, count;
};

template <bool kLdg = true>
RT_DEV NodeBox load_node(const Bvh& bvh, int i) {
  const float* nd = bvh.nodes + 9 * i;
  NodeBox b;
  b.lo = V3{ld<kLdg>(nd), ld<kLdg>(nd + 1), ld<kLdg>(nd + 2)};
  b.hi = V3{ld<kLdg>(nd + 3), ld<kLdg>(nd + 4), ld<kLdg>(nd + 5)};
  b.skip = static_cast<int>(ld<kLdg>(nd + 6));
  b.first = static_cast<int>(ld<kLdg>(nd + 7));
  b.count = static_cast<int>(ld<kLdg>(nd + 8));
  return b;
}

// bvh.py:_box_hit - the slab interval clamped to [t_min, t_max].
RT_DEV bool slab_hit(V3 lo, V3 hi, V3 o, V3 inv, float t_max) {
  float t0x = (lo.x - o.x) * inv.x, t1x = (hi.x - o.x) * inv.x;
  float t0y = (lo.y - o.y) * inv.y, t1y = (hi.y - o.y) * inv.y;
  float t0z = (lo.z - o.z) * inv.z, t1z = (hi.z - o.z) * inv.z;
  float near = fmaxf(fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z)), kTMin);
  float far = fminf(fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fmaxf(t0z, t1z)), t_max);
  return near <= far;
}

// K4's node test: the slab of the central light direction (inverse iv)
// against the box grown by _node_delta, the cone's reach at the box's
// farthest corner, near-clamped at 0.9949 * t_min.
RT_DEV bool cone_slab_hit(V3 lo, V3 hi, V3 p, V3 iv, float dist) {
  const float cone = 0.102f;
  const float tminc = 0.9949f * kTMin;
  float fx = fmaxf((lo.x - p.x) * (lo.x - p.x), (hi.x - p.x) * (hi.x - p.x));
  float fy = fmaxf((lo.y - p.y) * (lo.y - p.y), (hi.y - p.y) * (hi.y - p.y));
  float fz = fmaxf((lo.z - p.z) * (lo.z - p.z), (hi.z - p.z) * (hi.z - p.z));
  float delta = cone * fminf(sqrtf(fx + fy + fz), dist);
  float t0x = (lo.x - delta - p.x) * iv.x;
  float t1x = (hi.x + delta - p.x) * iv.x;
  float t0y = (lo.y - delta - p.y) * iv.y;
  float t1y = (hi.y + delta - p.y) * iv.y;
  float t0z = (lo.z - delta - p.z) * iv.z;
  float t1z = (hi.z + delta - p.z) * iv.z;
  float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                     fmaxf(fminf(t0z, t1z), tminc));
  float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                    fminf(fmaxf(t0z, t1z), dist));
  return near <= far;
}

// One ray's walk of the tree, in the 4-wide order when the tables hold the
// 4-wide view (n_wide > 0), else the binary order. enter(lo, hi): is a box
// entered (its slab test, with the walk's current state); leaf(first,
// count): run a boxed leaf, returning true to end the walk. A wide node's
// four slots are tested before any of them runs, as in closest_fn_wide.
// Both orders are in every kernel entry (the previous K3+K4 took 155
// registers, 122 with the binary walk alone): entries of one order each
// were slower on the stream frames' ladder segments in a same-call A/B on
// the H100, although they took fewer registers (PERF.md). kLdg: the tree
// lies in global memory (else in shared memory).
template <bool kLdg = true, class Enter, class Leaf>
RT_DEV void walk_tree(const Bvh& bvh, Enter&& enter, Leaf&& leaf) {
  if (bvh.n_wide > 0) {
    int stack[kWideStack];
    int sp = 1;
    stack[0] = 0;
    while (sp > 0) {
      const float* w = bvh.wide + 36 * stack[--sp];
      bool boxed[4];
      for (int s = 0; s < 4; ++s) {
        const float* b = w + 9 * s;
        boxed[s] = enter(V3{ld<kLdg>(b), ld<kLdg>(b + 1), ld<kLdg>(b + 2)},
                         V3{ld<kLdg>(b + 3), ld<kLdg>(b + 4),
                            ld<kLdg>(b + 5)});
      }
      // A leaf that ends the walk ends it after the node's four slots, as
      // the JAX body sets sp = 0 after them. (A return from inside this
      // loop, or the loop kept rolled with `#pragma unroll 1`, came out of
      // ptxas -O3 with wrong soft-shadow verdicts on the H100, right at -O1
      // and in a host build of the same source; PERF.md.)
      bool done = false;
      for (int s = 0; s < 4; ++s) {
        if (!boxed[s]) continue;
        const float* m = w + 9 * s + 6;
        int child = static_cast<int>(ld<kLdg>(m));
        int count = static_cast<int>(ld<kLdg>(m + 2));
        if (count > 0 && !done)
          done = leaf(static_cast<int>(ld<kLdg>(m + 1)), count);
        // wide_walk admits a tree only when its stack bound fits
        if (child >= 0 && sp < kWideStack) stack[sp++] = child;
      }
      if (done) return;
    }
  } else {
    int cur = 0;
    for (int step = 0; step < bvh.n_nodes && cur < bvh.n_nodes; ++step) {
      NodeBox b = load_node<kLdg>(bvh, cur);
      if (!enter(b.lo, b.hi)) {
        cur = b.skip;
        continue;
      }
      if (b.count == 0) {
        ++cur;
        continue;
      }
      if (leaf(b.first, b.count)) return;
      cur = b.skip;
    }
  }
}

// The geometry policy of bounce.cuh over a tree: kLdg, the tree and the
// leaf rows lie in global memory (else in shared memory).
template <class Leaves, bool kLdg = true>
struct BvhGeo {
  static constexpr int kSphMat = Leaves::kSphMat;
  const Tables& tb;
  Leaves lv;
  Bvh bvh;
  // Work: [0] node slab tests and [1] sphere and [2] triangle tests of the
  // closest-hit and hard-shadow walks; [3] node slab tests and [4] (ray,
  // sphere) and [5] (ray, triangle) tests of the fused soft walks; [6]
  // brute-force plane and box tests.
  int work[7];

  RT_DEV const float* sphere_row(int i) const { return lv.sphere_row(i); }
  RT_DEV const float* triangle_row(int i) const {
    return lv.triangle_row(i);
  }

  RT_DEV void closest(V3 o, V3 d, float* t_out, int* kind_out,
                      int* idx_out) {
    float a = dot3(d, d);
    float inv_a = 1.0f / a;
    V3 inv = safe_inverse(d);
    int b_idx;
    float t_box = closest_boxes(o, inv, &b_idx);  // seeds the walk
    float t_best = t_box;
    int best_kind = -1, best_id = 0;
    walk_tree<kLdg>(
        bvh,
        [&](V3 lo, V3 hi) {
          ++work[0];
          return slab_hit(lo, hi, o, inv, t_best);
        },
        [&](int first, int count) {
          for (int j = 0; j < bvh.leaf_size && j < count; ++j) {
            int id;
            const float* row;
            int k = lv.prim(first + j, &id, &row);
            if (k < 0) continue;  // a cube face
            float tj;
            if (k == 0) {
              ++work[1];
              float s[4];
              leaf_row<kLdg>(lv, row, 4, s);
              tj = sphere_t(o, d, a, inv_a, s, t_best);
            } else {
              ++work[2];
              float tr[9];
              leaf_row<kLdg>(lv, row, 9, tr);
              tj = triangle_t(o, d, tr, t_best);
            }
            if (tj < t_best) {
              t_best = tj;
              best_kind = k;
              best_id = id;
            }
          }
          return false;
        });
    closest_merge(o, d, t_best, best_kind, best_id, t_box, b_idx, t_out,
                  kind_out, idx_out);
  }

  // The boxes' closest hit, before the walk (b_idx: its box).
  RT_DEV float closest_boxes(V3 o, V3 inv, int* b_idx) {
    float t_box = kBig;
    *b_idx = 0;
    for (int j = 0; j < tb.nb; ++j) {
      ++work[6];
      float tj = box_t(o, inv, tb.box + 7 * j, kBig);
      if (tj < t_box) { t_box = tj; *b_idx = j; }
    }
    return t_box;
  }

  // After the walk (best_kind -1: no hit in the tree): the walk's hit,
  // then the boxes', then the planes'.
  RT_DEV void closest_merge(V3 o, V3 d, float t_best, int best_kind,
                            int best_id, float t_box, int b_idx,
                            float* t_out, int* kind_out, int* idx_out) {
    float t = kBig;
    int kind = -1, idx = 0;
    if (best_kind >= 0) {
      t = t_best;
      kind = best_kind;
      idx = best_id;
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
    bool blocked = false;
    walk_tree<kLdg>(
        bvh,
        [&](V3 lo, V3 hi) {
          ++work[0];
          return slab_hit(lo, hi, o, inv, t_max);
        },
        [&](int first, int count) {
          for (int j = 0; j < bvh.leaf_size && j < count; ++j) {
            int id;
            const float* row;
            int k = lv.prim(first + j, &id, &row);
            if (k < 0) continue;
            if (k == 0) {
              ++work[1];
              float s[4];
              leaf_row<kLdg>(lv, row, 4, s);
              blocked = sphere_t(o, d, a, inv_a, s, t_max) < kBig;
            } else {
              ++work[2];
              float tr[9];
              leaf_row<kLdg>(lv, row, 9, tr);
              blocked = triangle_blocked(o, d, tr, t_max);
            }
            if (blocked) return true;
          }
          return false;
        });
    return blocked;
  }

  // The planes and boxes of one soft-shadow ray sd, before the walk.
  RT_DEV bool soft_brute(V3 p, V3 sd, float dist) {
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
    return hit;
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
    F4 sd4[64];     // direction, |d|^2
    float sia[64];  // 1 / |d|^2
    for (int s = 0; s < S; ++s) {
      V3 sd = soft_dir(rays, ld, s0 + s);
      float a = dot3(sd, sd);
      sd4[s] = F4{sd.x, sd.y, sd.z, a};
      sia[s] = 1.0f / a;
    }
    const uint64_t full =
        S >= 64 ? ~0ull : ((1ull << static_cast<uint64_t>(S)) - 1ull);
    uint64_t bm = 0;  // bit s: ray s0 + s is blocked
    // planes and boxes outside the tree, every ray
    for (int s = 0; s < S; ++s)
      if (soft_brute(p, V3{sd4[s].x, sd4[s].y, sd4[s].z}, dist))
        bm |= 1ull << s;
    V3 iv = safe_inverse(ld);
    if (bm == full) return popc64(bm);
    walk_tree<kLdg>(
        bvh,
        [&](V3 lo, V3 hi) {
          ++work[3];
          return cone_slab_hit(lo, hi, p, iv, dist);
        },
        [&](int first, int count) {
          for (int j = 0; j < bvh.leaf_size && j < count && bm != full;
               ++j) {
            int id;
            const float* row;
            int k = lv.prim(first + j, &id, &row);
            if (k < 0) continue;
            if (k == 0) {
              float s[4];
              leaf_row<kLdg>(lv, row, 4, s);
              for (int r = 0; r < S; ++r) {
                if (bm >> r & 1ull) continue;
                ++work[4];
                F4 q = sd4[r];
                if (sphere_t(p, V3{q.x, q.y, q.z}, q.w, sia[r], s, dist) <
                    kBig)
                  bm |= 1ull << r;
              }
            } else {
              float tr[9];
              leaf_row<kLdg>(lv, row, 9, tr);
              TriPre T = tri_pre(p, tr);
              for (int r = 0; r < S; ++r) {
                if (bm >> r & 1ull) continue;
                ++work[5];
                F4 q = sd4[r];
                if (tri_blocked_pre(T, V3{q.x, q.y, q.z}, dist))
                  bm |= 1ull << r;
              }
            }
          }
          return bm == full;
        });
    return popc64(bm);
  }

  RT_DEV void store_work(int32_t* out) {
    for (int k = 0; k < 7; ++k) out[k] = work[k];
  }
};

}  // namespace rt
