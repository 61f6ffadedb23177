// K5: the bounce megakernel for stream-mode scenes (more than 4,096
// primitives with a scene BVH).
//
// Replaces raytrace_tpu/ops/megakernel.py:trace_pallas (:2987) built by
// _make_kernel(mode="stream") (_dma_leaf :813, _leaf_closest :909,
// _leaf_any :1190, _leaf_all :1504; wrapper :3080-3125): the walks of K3
// and K4 (bvh_walk.cuh) over the node table, in the 4-wide order (K3-wide)
// where bvh.py:wide_walk takes it, with each leaf's primitives
// read from the stream table (megakernel.pack_stream_table) instead of the
// sphere and triangle tables, and the bounce body of bounce.cuh (K1-ext,
// K1-state). Plain version: trace.py:trace, whose walks read the same rows
// (bvh.py:_RowLeaves).
//
// Stream table: [P + leaf_size][cols] floats, cols = tri_cols + 1 (14, or
// 23 with vertex normals): tag (0 sphere, 1 triangle, 2 cube-face
// triangle, -1 padding), then the triangle layout of bounce.cuh - v0.xyz,
// e1.xyz, e2.xyz, normal.xyz, mat, n0, n1, n2 - with a sphere's center in
// the v0 slot, its radius in e1.x and its mat in col 13. Rows are in leaf
// order: a leaf's primitives are rows [first, first + count). Cube faces
// (tag 2) are skipped by every trace walk, as in bvh mode: boxes are the
// hit form of cubes and stay brute force, as do planes. The hit's
// attributes come from its row, the same floats as the scene tables, so
// K5 equals K3+K4 on the same tree bit for bit.
//
// Design for Hopper. The TPU kernel copies each visited leaf's rows from
// HBM into a scalar-memory scratch because its node table fills most of
// that memory. Here the node walks stay per lane and each leaf's rows are
// read in place from global memory through the read-only cache. The
// closest-hit walk tests a leaf with the lanes of the warp that are in
// the same walk, one row a thread, and reduces to the least (t, slot)
// (stream_walk.cuh): a 32-row leaf is 1,792 or 2,944 contiguous bytes, so
// the group's loads coalesce, and lanes that hold no leaf help those that
// do. The hard-shadow and fused soft-shadow walks stay per thread, as in
// K3+K4 (their group forms lost on the H100; PERF.md), the soft walk with
// its rays packed two loads a test. Rows are not staged
// in shared memory: P1 (dma_probe.cu) measured a dependent row read
// through the read-only cache at 212 ns a step from the L2 on the H100,
// against 288-374 ns for a warp's cp.async copy and 272-304 ns for a bulk
// copy on an mbarrier, and shared memory's carve-out takes L1 from the
// rows and the walk stacks (PERF.md). At 262,144 primitives (the TPU
// kernel's cap, past which the JAX package leaves its kernels for a
// banded jnp engine) the node table is about 590 KB and the rows 24 MB
// (at 23 floats): both stay in global memory, inside the 50 MB L2; past
// it they grow by 92 bytes a primitive and spill out of the L2, and the
// kernel is the same. Its one limit is the node table's: first, count,
// skip and child are float32 integers, exact up to 2^24, so a scene may
// hold at most 2^24 primitives (megakernel.MAX_STREAM_ROWS); row offsets
// (cols * row < 23 * 2^24) stay inside int32, and the binary walk keeps
// no stack (the 4-wide walk, with its 64-entry stack, is taken only where
// bvh.py:wide_walk finds the stack bound fits). What bounds it: the
// latency of dependent loads and the divergence of the walks (a lane's
// next node depends on its last slab test); it is measured against its
// operations (chip_smoke.py).
#include "stream_walk.cuh"

template <bool kState>
RT_DEV void trace_stream_body(const rt::Lanes& io, const float* tables,
                              const rt::Dims& dims, const float* rows,
                              const rt::Run& run) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= io.n) return;
  rt::Tables tb = rt::make_tables(tables, dims);
  rt::Bvh bvh;
  rt::bvh_tables(tables, dims, &bvh);
  rt::RowLeaves lv{rows, dims.tri_cols + 1};
  rt::StreamGeo geo{{tb, lv, bvh, {0, 0, 0, 0, 0, 0, 0}},
                    io.counters != nullptr};
  rt::run_lane<kState>(geo, tb, io, run, lane, rt::kBvhCounters);
}

extern "C" __global__ void rt_trace_stream_kernel(
    rt::Lanes io, const float* __restrict__ tables, rt::Dims dims,
    const float* __restrict__ rows, rt::Run run) {
  trace_stream_body<false>(io, tables, dims, rows, run);
}

// K1-state: the same with lane state in or out (every launch of the split
// ladder).
extern "C" __global__ void rt_trace_stream_state_kernel(
    rt::Lanes io, const float* __restrict__ tables, rt::Dims dims,
    const float* __restrict__ rows, rt::Run run) {
  trace_stream_body<true>(io, tables, dims, rows, run);
}

#ifndef RT_HOST_EMULATION
// Launch K5 on `stream`; dims: the table sizes (bounce.cuh:Dims) as ints,
// with ns = nt = 0; rows: the stream table; tp_in, alive_in, state and
// counters may be null (bounce.cuh:Lanes). Returns cudaGetLastError()
// after the launch.
extern "C" int rt_trace_stream(const float* origin, const float* direction,
                               const int32_t* pix, const int32_t* samp,
                               const float* tp_in, const float* alive_in,
                               float* radiance, float* state,
                               int32_t* counters, int n_lanes,
                               const float* tables, const int* dims,
                               const float* rows, int start_bounce,
                               int end_bounce, int shadow_samples, int soft,
                               int recursive, uint32_t seed,
                               int rr_start, float tp_eps, int soft_guard,
                               void* stream) {
  const int threads = 128;
  rt::Dims d;
  memcpy(&d, dims, sizeof(d));
  rt::Lanes io = rt::make_lanes(origin, direction, pix, samp, tp_in,
                                alive_in, radiance, state, counters, n_lanes);
  rt::Run run{start_bounce, end_bounce, shadow_samples, soft, recursive,
              seed, rr_start, tp_eps, soft_guard};
  if (n_lanes > 0) {
    int blocks = (n_lanes + threads - 1) / threads;
    auto kernel = rt::stateful(io, run) ? rt_trace_stream_state_kernel
                                        : rt_trace_stream_kernel;
    kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        io, tables, d, rows, run);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
