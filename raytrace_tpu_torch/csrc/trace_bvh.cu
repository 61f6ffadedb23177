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
// All tables stay in global memory, read through the read-only cache:
// the scene tables as bounce.cuh lays them out, then the node table
// [n_nodes][9], the 4-wide table [n_wide][36] and prim_index [P]
// (bvh_walk.cuh). The bounce body is K1-ext's (smooth normals, kinds
// 7-12, textures). What bounds it: operations (slab and primitive tests);
// divergence between the walks of a warp's lanes is the cost this simple
// design accepts.
#include "bvh_walk.cuh"

template <bool kState>
RT_DEV void trace_bvh_body(const rt::Lanes& io, const float* tables,
                           const rt::Dims& dims, const rt::Run& run) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= io.n) return;
  rt::Tables tb = rt::make_tables(tables, dims);
  rt::Bvh bvh;
  const float* pidx = rt::bvh_tables(tables, dims, &bvh);
  rt::TreeLeaves lv{tb, pidx};
  rt::BvhGeo<rt::TreeLeaves> geo{tb, lv, bvh, {0, 0, 0, 0, 0, 0, 0}};
  rt::run_lane<kState>(geo, tb, io, run, lane, rt::kBvhCounters);
}

extern "C" __global__ void rt_trace_bvh_kernel(
    rt::Lanes io, const float* __restrict__ tables, rt::Dims dims,
    rt::Run run) {
  trace_bvh_body<false>(io, tables, dims, run);
}

// K1-state: the same with lane state in or out.
extern "C" __global__ void rt_trace_bvh_state_kernel(
    rt::Lanes io, const float* __restrict__ tables, rt::Dims dims,
    rt::Run run) {
  trace_bvh_body<true>(io, tables, dims, run);
}

#ifndef RT_HOST_EMULATION
// Launch K3+K4 on `stream`; dims: the table sizes (bounce.cuh:Dims) as
// ints; tp_in, alive_in, state and counters may be null
// (bounce.cuh:Lanes). Returns cudaGetLastError() after the launch.
extern "C" int rt_trace_bvh(const float* origin, const float* direction,
                            const int32_t* pix, const int32_t* samp,
                            const float* tp_in, const float* alive_in,
                            float* radiance, float* state, int32_t* counters,
                            int n_lanes, const float* tables, const int* dims,
                            int start_bounce, int end_bounce,
                            int shadow_samples, int soft, int recursive,
                            uint32_t seed, int rr_start, float tp_eps,
                            int soft_guard, void* stream) {
  const int threads = 128;
  rt::Dims d;
  memcpy(&d, dims, sizeof(d));
  rt::Lanes io = rt::make_lanes(origin, direction, pix, samp, tp_in,
                                alive_in, radiance, state, counters, n_lanes);
  rt::Run run{start_bounce, end_bounce, shadow_samples, soft, recursive,
              seed, rr_start, tp_eps, soft_guard};
  if (n_lanes > 0) {
    int blocks = (n_lanes + threads - 1) / threads;
    auto kernel = rt::stateful(io, run) ? rt_trace_bvh_state_kernel
                                        : rt_trace_bvh_kernel;
    kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        io, tables, d, run);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
