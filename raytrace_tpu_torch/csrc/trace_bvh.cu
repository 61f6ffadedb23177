// K3+K4: the bounce megakernel for bvh-mode scenes (97-4096 primitives
// with a scene BVH).
//
// Replaces raytrace_tpu/ops/megakernel.py:trace_pallas (:2987) built by
// _make_kernel(mode="bvh"): the bounce loop of bounce.cuh (one thread per
// lane, the whole depth loop) with the BVH geometry policy of
// bvh_walk.cuh - the closest-hit and hard-shadow walks (K3) and the fused
// soft-shadow walk (K4). Plain version: trace.py:trace, whose every ray
// walks the tree (bvh.py:traverse_closest, traverse_any).
//
// Design for Hopper. The TPU kernel keeps its scene and node tables out of
// HBM, in scalar memory (megakernel.py:62-64). Here the walks read one
// walk table (megakernel.pack_walk_table): the tree they take (the 4-wide
// table, or the binary one) and one 16-byte aligned row per leaf slot,
// with prim_index resolved when it was packed, so a leaf's primitive is
// one read, not an index and then its row. A block copies the table into
// dynamic shared memory once (16-byte loads), opting in above 48 KB; the
// bvh cap of 4096 slots at leaf size 16 takes about 221 KB of the 227 KB
// a block can hold. A table past the wrapper's budget
// (megakernel.BVH_SMEM_BYTES: a tree of smaller leaves) is read in place
// from global memory through the read-only cache by the same code
// (kLdg). The scene tables (lights, materials, textures, planes, boxes,
// the hit's attributes by id) stay in global memory.
//
// The blocks are persistent (common.cuh): as many as fit the SMs at this
// entry's registers and shared memory, so a large table is copied once an
// SM-resident block, not once every 128 lanes. Each warp takes the next 32
// lanes from a lane counter (one atomicAdd a warp, broadcast by a shuffle)
// until none are left; the launcher zeroes the counter. What bounds
// it: operations (slab and primitive tests); divergence between the walks
// of a warp's lanes is the cost this design accepts.
#include "bvh_walk.cuh"

// The lanes of the persistent blocks over a walk table in shared memory
// (kSmem) or in global memory.
template <bool kState, bool kSmem>
RT_DEV void trace_walk_lanes(const rt::Lanes& io, const float* tables,
                             const rt::Dims& dims, const float* walk,
                             int32_t* next, const rt::Run& run) {
  constexpr bool kLdg = !kSmem;
  rt::Tables tb = rt::make_tables(tables, dims);
  rt::Bvh bvh;
  const float* rows = rt::walk_tables(walk, dims, &bvh);
  rt::WalkLeaves<kLdg> lv{tb, rows};
  rt::for_lanes(io.n, next, [&](int lane) {
    rt::BvhGeo<rt::WalkLeaves<kLdg>, kLdg> geo{tb, lv, bvh,
                                               {0, 0, 0, 0, 0, 0, 0}};
    rt::run_lane<kState>(geo, tb, io, run, lane, rt::kBvhCounters);
  });
}

template <bool kState>
RT_DEV void trace_bvh_body(const rt::Lanes& io, const float* tables,
                           const rt::Dims& dims, const float* walk,
                           int walk_floats, int in_smem, int32_t* next,
                           const rt::Run& run) {
  extern __shared__ __align__(16) float smem[];
  if (in_smem) {
    rt::copy_to_smem(smem, walk, walk_floats);
    __syncthreads();
    trace_walk_lanes<kState, true>(io, tables, dims, smem, next, run);
  } else {
    trace_walk_lanes<kState, false>(io, tables, dims, walk, next, run);
  }
}

// The threads of a block of the persistent entries, at least one such
// block an SM: 384 x 168 registers fill an SM's 65,536. (Blocks of 128
// and 256 threads were slower in a same-call A/B on the H100; without the
// 1, ptxas cut the entries to 80 registers, for two blocks an SM, and
// spilled 2.7-3.2 KB a thread: slower with soft shadows on every bvh
// bench frame; PERF.md.)
#define RT_BVH_THREADS 384

extern "C" __global__ void __launch_bounds__(RT_BVH_THREADS, 1)
rt_trace_bvh_kernel(
    rt::Lanes io, const float* __restrict__ tables, rt::Dims dims,
    const float* __restrict__ walk, int walk_floats, int in_smem,
    int32_t* next, rt::Run run) {
  trace_bvh_body<false>(io, tables, dims, walk, walk_floats, in_smem, next,
                        run);
}

// K1-state: the same with lane state in or out.
extern "C" __global__ void __launch_bounds__(RT_BVH_THREADS, 1)
rt_trace_bvh_state_kernel(
    rt::Lanes io, const float* __restrict__ tables, rt::Dims dims,
    const float* __restrict__ walk, int walk_floats, int in_smem,
    int32_t* next, rt::Run run) {
  trace_bvh_body<true>(io, tables, dims, walk, walk_floats, in_smem, next,
                       run);
}

#ifndef RT_HOST_EMULATION
// Launch K3+K4 on `stream`; dims: the table sizes (bounce.cuh:Dims) as
// ints; walk: the walk table (megakernel.pack_walk_table), walk_floats
// long (a multiple of 4, 16-byte aligned); in_smem: copy it to shared
// memory (it fits the budget), else read it in place; next: an int32
// lane counter (zeroed here, on the stream, before the kernel); tp_in,
// alive_in, state and counters may be null (bounce.cuh:Lanes). Returns
// cudaGetLastError() after the launch: a launch refused for its shared
// memory or its registers reports it there.
extern "C" int rt_trace_bvh(const float* origin, const float* direction,
                            const int32_t* pix, const int32_t* samp,
                            const float* tp_in, const float* alive_in,
                            float* radiance, float* state, int32_t* counters,
                            int n_lanes, const float* tables, const int* dims,
                            const float* walk, int walk_floats, int in_smem,
                            int32_t* next, int start_bounce,
                            int end_bounce, int shadow_samples, int soft,
                            int recursive, uint32_t seed, int rr_start,
                            float tp_eps, int soft_guard, void* stream) {
  const int threads = RT_BVH_THREADS;
  rt::Dims d;
  memcpy(&d, dims, sizeof(d));
  rt::Lanes io = rt::make_lanes(origin, direction, pix, samp, tp_in,
                                alive_in, radiance, state, counters, n_lanes);
  rt::Run run{start_bounce, end_bounce, shadow_samples, soft, recursive,
              seed, rr_start, tp_eps, soft_guard};
  if (n_lanes > 0) {
    auto kernel = rt::stateful(io, run) ? rt_trace_bvh_state_kernel
                                        : rt_trace_bvh_kernel;
    size_t smem = in_smem ? static_cast<size_t>(walk_floats) * sizeof(float)
                          : 0;
    int blocks = rt::persistent_blocks(kernel, threads, smem, n_lanes);
    cudaMemsetAsync(next, 0, sizeof(int32_t),
                    static_cast<cudaStream_t>(stream));
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        io, tables, d, walk, walk_floats, in_smem, next, run);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
