// K1: the bounce megakernel for scenes of at most 96 primitives (48 in a
// smooth-shaded scene).
//
// Replaces raytrace_tpu/ops/megakernel.py:trace_pallas (:2987) built by
// _make_kernel(mode="unroll") (:278; kernel :772, closest_hit :370,
// _box_closest :454, occl_precompute :499, any_hit_pre :550, bounce body
// :1876), with the extended body of K1-ext (bounce.cuh). Semantics are
// those of the plain version, trace.py:trace, which is checked lane for
// lane against the JAX engine.
//
// Design for Hopper. One thread traces one lane through the whole depth
// loop (bounce.cuh); lanes are flat (B,) arrays. The scene tables (<= 96
// primitives, material rows, lights, textures; a few KB) are tested by
// brute force (brute_force.cuh) from shared memory. The blocks are
// persistent (common.cuh): as many as are resident at this entry's
// registers, each copying the tables into shared memory once with 16-byte
// loads, each warp taking the next 32 lanes from a lane counter until
// none are left - not one block, and one copy of the tables, every 128
// lanes. Depth, light, sample and primitive counts are run-time loop
// bounds, and no loop waits on data. Occlusion tests stop at the first
// blocker, which leaves the verdict unchanged, and the soft-shadow loop
// runs behind K1-guard (brute_force.cuh): a per-occluder cone test that
// skips the occluders which cannot block any of a light's soft rays
// (Run.soft_guard, 1 on the main path). What bounds it: operations, not
// bytes - each lane reads 32 bytes and writes 12, but a bounce runs up to
// 1 + lights * (1 + samples) rays against every primitive. Divergence
// between lanes of a warp (a glass lane bouncing 50 times beside a dead
// one) is the cost this simple design accepts; a warp takes its next 32
// lanes when its longest lane ends.
//
// Table layout: bounce.cuh.
#include "brute_force.cuh"

template <bool kState>
RT_DEV void trace_unroll_body(const rt::Lanes& io, const float* tables,
                              const rt::Dims& dims, int32_t* next,
                              const rt::Run& run) {
  extern __shared__ __align__(16) float smem[];
  rt::copy_to_smem(smem, tables, rt::table_floats(dims));
  __syncthreads();
  rt::Tables tb = rt::make_tables(smem, dims);
  rt::for_lanes(io.n, next, [&](int lane) {
    rt::brute_lane<false, kState, false>(tb, io, run, lane);
  });
}

extern "C" __global__ void __launch_bounds__(RT_BRUTE_THREADS,
                                             RT_UNROLL_MIN_BLOCKS)
rt_trace_unroll_kernel(rt::Lanes io, const float* __restrict__ tables,
                       rt::Dims dims, int32_t* next, rt::Run run) {
  trace_unroll_body<false>(io, tables, dims, next, run);
}

// K1-state: the same with lane state in or out.
extern "C" __global__ void __launch_bounds__(RT_BRUTE_THREADS,
                                             RT_UNROLL_MIN_BLOCKS)
rt_trace_unroll_state_kernel(rt::Lanes io, const float* __restrict__ tables,
                             rt::Dims dims, int32_t* next, rt::Run run) {
  trace_unroll_body<true>(io, tables, dims, next, run);
}

#ifndef RT_HOST_EMULATION
// Launch K1 on `stream`; dims: the table sizes (bounce.cuh:Dims) as ints;
// next: an int32 lane counter (zeroed here, on the stream, before the
// kernel); tp_in, alive_in, state and
// counters may be null (bounce.cuh:Lanes). Returns cudaGetLastError()
// after the launch.
extern "C" int rt_trace_unroll(const float* origin, const float* direction,
                               const int32_t* pix, const int32_t* samp,
                               const float* tp_in, const float* alive_in,
                               float* radiance, float* state,
                               int32_t* counters, int n_lanes,
                               const float* tables, const int* dims,
                               int32_t* next, int start_bounce,
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
  size_t smem = static_cast<size_t>(rt::table_floats(d)) * sizeof(float);
  if (n_lanes > 0) {
    auto kernel = rt::stateful(io, run) ? rt_trace_unroll_state_kernel
                                        : rt_trace_unroll_kernel;
    int blocks = rt::persistent_blocks(kernel, threads, smem, n_lanes);
    cudaMemsetAsync(next, 0, sizeof(int32_t),
                    static_cast<cudaStream_t>(stream));
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        io, tables, d, next, run);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
