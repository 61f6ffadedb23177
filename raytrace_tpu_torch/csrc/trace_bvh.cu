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
// [n_nodes][9] and prim_index [P] (bvh_walk.cuh). The bounce body is
// K1-ext's (smooth normals, kinds 7-12, textures). What bounds it:
// operations (slab and primitive tests); divergence between the walks of
// a warp's lanes is the cost this simple design accepts.
#include "bvh_walk.cuh"

extern "C" __global__ void rt_trace_bvh_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const int32_t* __restrict__ pix, const int32_t* __restrict__ samp,
    float* __restrict__ radiance, int32_t* __restrict__ counters,
    int n_lanes, const float* __restrict__ tables, rt::Dims dims,
    int max_depth, int shadow_samples, int soft, int recursive,
    uint32_t seed) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  rt::Tables tb = rt::make_tables(tables, dims);
  rt::Bvh bvh;
  bvh.nodes = tables + rt::table_floats(dims);
  bvh.pidx = bvh.nodes + 9 * dims.n_nodes;
  bvh.n_nodes = dims.n_nodes;
  bvh.leaf_size = dims.leaf_size;
  rt::BvhGeo geo{tb, bvh, {0, 0, 0, 0, 0, 0, 0}};
  const float* o = origin + 3 * lane;
  const float* d = direction + 3 * lane;
  rt::trace_lane(geo, tb, rt::V3{o[0], o[1], o[2]}, rt::V3{d[0], d[1], d[2]},
                 static_cast<uint32_t>(pix[lane]),
                 static_cast<uint32_t>(samp[lane]), max_depth, shadow_samples,
                 soft != 0, recursive != 0, seed, radiance + 3 * lane,
                 counters == nullptr ? nullptr
                                     : counters + rt::kBvhCounters * lane);
}

#ifndef RT_HOST_EMULATION
// Launch K3+K4 on `stream`; dims: the table sizes (bounce.cuh:Dims) as
// ints. Returns cudaGetLastError() after the launch.
extern "C" int rt_trace_bvh(const float* origin, const float* direction,
                            const int32_t* pix, const int32_t* samp,
                            float* radiance, int32_t* counters, int n_lanes,
                            const float* tables, const int* dims,
                            int max_depth, int shadow_samples, int soft,
                            int recursive, uint32_t seed, void* stream) {
  const int threads = 128;
  rt::Dims d;
  memcpy(&d, dims, sizeof(d));
  if (n_lanes > 0) {
    int blocks = (n_lanes + threads - 1) / threads;
    rt_trace_bvh_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        origin, direction, pix, samp, radiance, counters, n_lanes, tables, d,
        max_depth, shadow_samples, soft, recursive, seed);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
