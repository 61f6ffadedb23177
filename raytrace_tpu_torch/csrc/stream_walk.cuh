// K5's closest-hit walk: the walk of bvh_walk.cuh over the stream table's
// leaf rows, with each leaf tested by a group of threads instead of by
// its lane alone.
//
// Replaces, in raytrace_tpu/ops/megakernel.py:_make_kernel(mode="stream"),
// the closest-hit leaf visits: _dma_leaf (:813), which copies a visited
// leaf's rows into scalar memory as one block, and _leaf_closest (:909),
// which tests the copied block. On Hopper the unit that matches a 32-row
// leaf is a warp: 32 rows, 32 threads.
//
// Nodes stay per lane: each lane walks its own stack, in the 4-wide or
// the binary order of walk_tree (bvh_walk.cuh), with its own t_best in
// the slab tests. A lane that reaches a node with boxed leaf slots stops
// there; the lanes of the warp that entered the walk together (the group,
// __activemask() at the walk's entry: lanes leave the bounce loop at
// different bounces and under roulette, so never a full-warp mask) then
// take the pending leaves one owner after another, in lane order, and an
// owner's leaves in slot order. For each leaf the owner's ray and t_best
// are broadcast, thread r of a group of g tests rows r, r + g, r + 2g, ...
// (one row a thread for a 32-row leaf and a full warp; leaves of 64-512
// rows loop), neighbouring threads reading neighbouring rows of the
// leaf's contiguous block, and the group takes the lexicographic minimum
// of (t, slot) over the rows, accepted if t < t_best at the leaf's entry,
// strictly. This is the per-thread loop's winner bit for bit: a row's
// sphere_t or triangle_t returns the same t whatever t_max it is given,
// wherever that t could win (a root past the smaller bound is refused by
// both or loses to the current best in the loop), and the loop's strict
// tj < t_best in slot order keeps the lowest slot of the least t, as the
// lexicographic minimum does (t >= t_min > 0, so the minimum of the float
// bits as unsigned is the least t). The owner's t_best after each leaf is
// the per-thread walk's, so the walk visits the nodes the per-thread walk
// visits, in the same order.
//
// The hard-shadow and fused soft-shadow walks stay per thread: the group
// form of each was slower on the stream frames in a same-call A/B on the
// H100, and a group hard-shadow walk made the per-thread soft walk after
// it slower too (PERF.md). The hard-shadow and fused soft walks are
// BvhGeo's (the soft rays packed two local loads a (row, ray) test, which
// ran K5 1-5% faster on both stream frames in a same-call A/B).
//
// The work counters keep counting the per-thread walk's work, which is
// what these inputs need: every valid row of a visited leaf, summed over
// the group (in a launch with counters only).
//
// Under RT_HOST_EMULATION the group is one thread and the warp
// intrinsics are the identity.
#pragma once

#include "bvh_walk.cuh"

namespace rt {

// Leaf slots as rows of the stream table (trace_stream.cu).
struct RowLeaves {
  static constexpr int kSphMat = 12;  // (row + 1)[12] is col 13
  const float* rows;
  int cols;

  // As WalkLeaves::prim; *id is the row, *row its cols 1...
  RT_DEV int prim(int slot, int* id, const float** row) const {
    const float* r = rows + cols * slot;
    int tag = static_cast<int>(ldg(r));
    *id = slot;
    *row = r + 1;
    return tag == 0 ? 0 : (tag == 1 ? 1 : -1);
  }
  RT_DEV const float* sphere_row(int i) const { return rows + cols * i + 1; }
  RT_DEV const float* triangle_row(int i) const {
    return rows + cols * i + 1;
  }
};

// ------------------------------------------------------------ group ----
// The lanes of a warp that run one walk together.
struct Group {
  unsigned mask;  // the lanes, as bits of the warp
  int lane;       // this thread's lane
  int rank;       // its place among them
  int size;
};

RT_DEV Group group_here() {
#ifndef RT_HOST_EMULATION
  unsigned m = __activemask();
  int lane = static_cast<int>(threadIdx.x & 31u);
  return Group{m, lane, __popc(m & ((1u << lane) - 1u)), __popc(m)};
#else
  return Group{1u, 0, 0, 1};
#endif
}

RT_DEV unsigned g_ballot(const Group& g, bool p) {
#ifndef RT_HOST_EMULATION
  return __ballot_sync(g.mask, p);
#else
  return p ? 1u : 0u;
#endif
}

template <class T>
RT_DEV T g_shfl(const Group& g, T v, int src) {
#ifndef RT_HOST_EMULATION
  return __shfl_sync(g.mask, v, src);
#else
  return v;
#endif
}

RT_DEV unsigned g_min(const Group& g, unsigned v) {
#ifndef RT_HOST_EMULATION
  return __reduce_min_sync(g.mask, v);
#else
  return v;
#endif
}

RT_DEV unsigned g_add(const Group& g, unsigned v) {
#ifndef RT_HOST_EMULATION
  return __reduce_add_sync(g.mask, v);
#else
  return v;
#endif
}

RT_DEV unsigned f2u(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}

RT_DEV float u2f(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// The walk of walk_tree (bvh_walk.cuh), node for node and in the same
// order, with the leaves taken by the group. enter(lo, hi): this lane's
// slab test of a box. leaves(owners, node, slots): the group takes the
// pending leaves of every owner lane (bits of `owners`; each lane passes
// its own node and the bits of its boxed leaf slots, 0 for none). A lane
// stops walking at the first node with boxed leaves, as the per-thread
// walk runs them before its next slab test.
template <class Enter, class Leaves>
RT_DEV void walk_group(const Bvh& bvh, const Group& g, Enter&& enter,
                       Leaves&& leaves) {
  int stack[kWideStack];
  int sp = 1, cur = 0, step = 0;
  stack[0] = 0;
  bool walking = true;
  while (true) {
    int node = 0;
    unsigned slots = 0;
    while (walking && slots == 0) {
      if (bvh.n_wide > 0) {
        if (sp == 0) {
          walking = false;
          break;
        }
        node = stack[--sp];
        const float* w = bvh.wide + 36 * node;
        bool boxed[4];
        for (int s = 0; s < 4; ++s) {
          const float* b = w + 9 * s;
          boxed[s] = enter(V3{ldg(b), ldg(b + 1), ldg(b + 2)},
                           V3{ldg(b + 3), ldg(b + 4), ldg(b + 5)});
        }
        for (int s = 0; s < 4; ++s) {
          if (!boxed[s]) continue;
          const float* m = w + 9 * s + 6;
          int child = static_cast<int>(ldg(m));
          if (static_cast<int>(ldg(m + 2)) > 0) slots |= 1u << s;
          if (child >= 0 && sp < kWideStack) stack[sp++] = child;
        }
      } else {
        if (step >= bvh.n_nodes || cur >= bvh.n_nodes) {
          walking = false;
          break;
        }
        ++step;
        NodeBox b = load_node(bvh, cur);
        if (!enter(b.lo, b.hi)) {
          cur = b.skip;
        } else if (b.count == 0) {
          ++cur;
        } else {
          node = cur;
          slots = 1u;
          cur = b.skip;
        }
      }
    }
    unsigned owners = g_ballot(g, slots != 0u);
    if (owners == 0u) return;
    leaves(owners, node, slots);
  }
}

// K5's geometry: BvhGeo over the stream rows, with the group closest-hit
// walk.
struct StreamGeo : BvhGeo<RowLeaves> {
  bool count;  // a launch with counters: count the per-thread walk's work

  // The first and count of leaf slot s of a node (a wide node's slot, or
  // the binary node itself: both rows keep them at 7 and 8).
  RT_DEV void leaf_of(int node, int s, int* first, int* n_rows) const {
    const float* m = bvh.n_wide > 0 ? bvh.wide + 36 * node + 9 * s
                                    : bvh.nodes + 9 * node;
    *first = static_cast<int>(ldg(m + 7));
    int n = static_cast<int>(ldg(m + 8));
    *n_rows = n < bvh.leaf_size ? n : bvh.leaf_size;
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
    const Group g = group_here();
    walk_group(
        bvh, g,
        [&](V3 lo, V3 hi) {
          ++work[0];
          return slab_hit(lo, hi, o, inv, t_best);
        },
        [&](unsigned owners, int node, unsigned slots) {
          while (owners) {
            int src = ffs32(owners) - 1;
            owners &= owners - 1u;
            V3 ro{g_shfl(g, o.x, src), g_shfl(g, o.y, src),
                  g_shfl(g, o.z, src)};
            V3 rd{g_shfl(g, d.x, src), g_shfl(g, d.y, src),
                  g_shfl(g, d.z, src)};
            float ra = g_shfl(g, a, src), ria = g_shfl(g, inv_a, src);
            float tb = g_shfl(g, t_best, src);
            int kind = g_shfl(g, best_kind, src), id = g_shfl(g, best_id, src);
            int o_node = g_shfl(g, node, src);
            unsigned o_slots = g_shfl(g, slots, src);
            unsigned n_sph = 0, n_tri = 0;
            for (; o_slots; o_slots &= o_slots - 1u) {
              int first, n_rows;
              leaf_of(o_node, ffs32(o_slots) - 1, &first, &n_rows);
              float t_loc = tb;     // this thread's best row: t, then
              unsigned key = ~0u;   // 2 * slot + kind
              for (int j = g.rank; j < n_rows; j += g.size) {
                int rid;
                const float* row;
                int k = lv.prim(first + j, &rid, &row);
                if (k < 0) continue;  // a cube face or padding
                float tj;
                if (k == 0) {
                  ++n_sph;
                  float s[4];
                  load_row<true>(row, 4, s);
                  tj = sphere_t(ro, rd, ra, ria, s, tb);
                } else {
                  ++n_tri;
                  float tr[9];
                  load_row<true>(row, 9, tr);
                  tj = triangle_t(ro, rd, tr, tb);
                }
                if (tj < t_loc) {
                  t_loc = tj;
                  key = 2u * static_cast<unsigned>(j) +
                        static_cast<unsigned>(k);
                }
              }
              float t_min = u2f(g_min(g, f2u(t_loc)));
              if (t_min < tb) {
                unsigned win = g_min(g, t_loc == t_min ? key : ~0u);
                tb = t_min;
                kind = static_cast<int>(win & 1u);
                id = first + static_cast<int>(win >> 1);
              }
            }
            if (g.lane == src) {
              t_best = tb;
              best_kind = kind;
              best_id = id;
            }
            if (count) {
              unsigned c = g_add(g, n_sph | n_tri << 16);
              if (g.lane == src) {
                work[1] += static_cast<int>(c & 0xFFFFu);
                work[2] += static_cast<int>(c >> 16);
              }
            }
          }
        });
    closest_merge(o, d, t_best, best_kind, best_id, t_box, b_idx, t_out,
                  kind_out, idx_out);
  }
};

}  // namespace rt
