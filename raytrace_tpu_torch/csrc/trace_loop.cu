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
// first-minimum tie order, its box-occluder split (cube faces are left out
// of the tests, their boxes are the hit form) and K1-guard, here over any
// number of occluders (in chunks of 96), over the same bounce body
// (bounce.cuh), in K1's persistent blocks (common.cuh): as many blocks as
// are resident, each copying the tables into dynamic shared memory once
// with 16-byte loads, opting in above 48 KB, while they fit the budget
// that the wrapper states (megakernel.LOOP_SMEM_BYTES, the most an H100
// block can take: 232,448 bytes, some 11,600 spheres); each warp takes the
// next 32 lanes from the lane counter. Past the budget the tables stay in
// global memory and every row is read through the read-only cache
// (__ldg) by the same code (kLdg). What bounds it: operations - every
// closest-hit and hard-shadow ray tests every primitive, and every soft
// ray the occluders its guard flags, so the work grows with the table
// while the bytes (32 in and 12 out per lane) do not.
//
// Table layout: bounce.cuh.
#include "brute_force.cuh"

template <bool kState>
RT_DEV void trace_loop_body(const rt::Lanes& io, const float* tables,
                            const rt::Dims& dims, int in_smem,
                            int32_t* next, const rt::Run& run) {
  extern __shared__ __align__(16) float smem[];
  if (in_smem) {
    rt::copy_to_smem(smem, tables, rt::table_floats(dims));
    __syncthreads();
    rt::Tables tb = rt::make_tables(smem, dims);
    rt::for_lanes(io.n, next, [&](int lane) {
      rt::brute_lane<false, kState, true>(tb, io, run, lane);
    });
  } else {
    rt::Tables tb = rt::make_tables(tables, dims);
    rt::for_lanes(io.n, next, [&](int lane) {
      rt::brute_lane<true, kState, true>(tb, io, run, lane);
    });
  }
}

extern "C" __global__ void __launch_bounds__(RT_BRUTE_THREADS,
                                             RT_LOOP_MIN_BLOCKS)
rt_trace_loop_kernel(rt::Lanes io, const float* __restrict__ tables,
                     rt::Dims dims, int in_smem, int32_t* next,
                     rt::Run run) {
  trace_loop_body<false>(io, tables, dims, in_smem, next, run);
}

// K1-state: the same with lane state in or out.
extern "C" __global__ void __launch_bounds__(RT_BRUTE_THREADS,
                                             RT_LOOP_MIN_BLOCKS)
rt_trace_loop_state_kernel(rt::Lanes io, const float* __restrict__ tables,
                           rt::Dims dims, int in_smem, int32_t* next,
                           rt::Run run) {
  trace_loop_body<true>(io, tables, dims, in_smem, next, run);
}

#ifndef RT_HOST_EMULATION
// Launch K7 on `stream`; dims: the table sizes (bounce.cuh:Dims) as ints;
// in_smem: copy the tables to shared memory (they fit the budget); next:
// an int32 lane counter (zeroed here, on the stream, before the kernel);
// tp_in, alive_in, state and counters may be null (bounce.cuh:Lanes).
// Returns cudaGetLastError() after the launch: a launch refused for its
// shared memory reports it there.
extern "C" int rt_trace_loop(const float* origin, const float* direction,
                             const int32_t* pix, const int32_t* samp,
                             const float* tp_in, const float* alive_in,
                             float* radiance, float* state,
                             int32_t* counters, int n_lanes,
                             const float* tables, const int* dims,
                             int in_smem, int32_t* next, int start_bounce,
                             int end_bounce, int shadow_samples, int soft,
                             int recursive, uint32_t seed, int rr_start,
                             float tp_eps, int soft_guard, void* stream) {
  const int threads = RT_BRUTE_THREADS;
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
    auto kernel = rt::stateful(io, run) ? rt_trace_loop_state_kernel
                                        : rt_trace_loop_kernel;
    int blocks = rt::persistent_blocks(kernel, threads, smem, n_lanes);
    cudaMemsetAsync(next, 0, sizeof(int32_t),
                    static_cast<cudaStream_t>(stream));
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        io, tables, d, in_smem, next, run);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
