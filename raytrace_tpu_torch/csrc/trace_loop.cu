// K7: the bounce megakernel for scenes without a BVH past the unroll
// limit (more than 96 primitives, or 48 in a smooth-shaded scene), brute
// force over tables of any size.
//
// Replaces raytrace_tpu/ops/megakernel.py:trace_pallas (:2987) built by
// _make_kernel(mode="loop") (:278; closest_hit_loop :608, any_hit_loop
// :690, dispatch :1682-1700), and, past 96 primitives, the JAX Renderer's
// brute-force jnp engine, which computes the same function (renderer.py
// :889-930). Plain version: trace.py:trace.
//
// Design for Hopper. K1's brute-force policy (brute_force.cuh) with its
// first-minimum tie order and its box-occluder split (cube faces are left
// out of the tests, their boxes are the hit form), over the same bounce
// body (bounce.cuh). The tables go to shared memory while they fit the
// budget that the wrapper states (megakernel.LOOP_SMEM_BYTES: 48 KB, the
// most a block takes without opting in); past it they stay in global
// memory and every row is read through the read-only cache (__ldg), as K3
// reads its tables. What bounds it: operations - every ray tests every
// primitive, so the work grows with the table while the bytes (32 in and
// 12 out per lane) do not.
//
// Table layout: bounce.cuh.
#include "brute_force.cuh"

template <bool kState>
RT_DEV void trace_loop_body(const rt::Lanes& io, const float* tables,
                            const rt::Dims& dims, int in_smem,
                            const rt::Run& run) {
  extern __shared__ float smem[];
  if (in_smem) {
    const int n_table = rt::table_floats(dims);
    for (int i = threadIdx.x; i < n_table; i += blockDim.x)
      smem[i] = tables[i];
    __syncthreads();
  }
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= io.n) return;
  if (in_smem) {
    rt::Tables tb = rt::make_tables(smem, dims);
    rt::brute_lane<false, kState, false>(tb, io, run, lane);
  } else {
    rt::Tables tb = rt::make_tables(tables, dims);
    rt::brute_lane<true, kState, false>(tb, io, run, lane);
  }
}

extern "C" __global__ void rt_trace_loop_kernel(
    rt::Lanes io, const float* __restrict__ tables, rt::Dims dims,
    int in_smem, rt::Run run) {
  trace_loop_body<false>(io, tables, dims, in_smem, run);
}

// K1-state: the same with lane state in or out.
extern "C" __global__ void rt_trace_loop_state_kernel(
    rt::Lanes io, const float* __restrict__ tables, rt::Dims dims,
    int in_smem, rt::Run run) {
  trace_loop_body<true>(io, tables, dims, in_smem, run);
}

#ifndef RT_HOST_EMULATION
// Launch K7 on `stream`; dims: the table sizes (bounce.cuh:Dims) as ints;
// in_smem: copy the tables to shared memory (they fit the budget); tp_in,
// alive_in, state and counters may be null (bounce.cuh:Lanes). Returns
// cudaGetLastError() after the launch.
extern "C" int rt_trace_loop(const float* origin, const float* direction,
                             const int32_t* pix, const int32_t* samp,
                             const float* tp_in, const float* alive_in,
                             float* radiance, float* state,
                             int32_t* counters, int n_lanes,
                             const float* tables, const int* dims,
                             int in_smem, int start_bounce, int end_bounce,
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
  size_t smem = in_smem ? static_cast<size_t>(rt::table_floats(d)) *
                              sizeof(float)
                        : 0;
  if (n_lanes > 0) {
    int blocks = (n_lanes + threads - 1) / threads;
    auto kernel = rt::stateful(io, run) ? rt_trace_loop_state_kernel
                                        : rt_trace_loop_kernel;
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        io, tables, d, in_smem, run);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
