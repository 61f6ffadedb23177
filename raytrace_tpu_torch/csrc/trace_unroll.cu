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
// primitives, material rows, lights, textures; a few KB) are copied once
// per block into shared memory and tested by brute force (brute_force.cuh).
// Depth, light, sample and primitive counts are run-time loop bounds, and
// no loop waits on data. Occlusion tests stop at the first blocker, which
// leaves the verdict unchanged, and the soft-shadow loop runs behind
// K1-guard (brute_force.cuh): a per-occluder cone test that skips the
// occluders which cannot block any of a light's soft rays (Run.soft_guard,
// 1 on the main path). What bounds it: operations, not bytes -
// each lane reads 32 bytes and writes 12, but a bounce runs up to
// 1 + lights * (1 + samples) rays against every primitive. Divergence
// between lanes of a warp (a glass lane bouncing 50 times beside a dead
// one) is the cost this simple design accepts; survivor re-compaction is
// later work.
//
// Table layout: bounce.cuh.
#include "brute_force.cuh"

template <bool kState>
RT_DEV void trace_unroll_body(const rt::Lanes& io, const float* tables,
                              const rt::Dims& dims, const rt::Run& run) {
  extern __shared__ float smem[];
  const int n_table = rt::table_floats(dims);
  for (int i = threadIdx.x; i < n_table; i += blockDim.x) smem[i] = tables[i];
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= io.n) return;
  rt::Tables tb = rt::make_tables(smem, dims);
  rt::brute_lane<false, kState, true>(tb, io, run, lane);
}

extern "C" __global__ void rt_trace_unroll_kernel(
    rt::Lanes io, const float* __restrict__ tables, rt::Dims dims,
    rt::Run run) {
  trace_unroll_body<false>(io, tables, dims, run);
}

// K1-state: the same with lane state in or out.
extern "C" __global__ void rt_trace_unroll_state_kernel(
    rt::Lanes io, const float* __restrict__ tables, rt::Dims dims,
    rt::Run run) {
  trace_unroll_body<true>(io, tables, dims, run);
}

#ifndef RT_HOST_EMULATION
// Launch K1 on `stream`; dims: the table sizes (bounce.cuh:Dims) as ints;
// tp_in, alive_in, state and counters may be null (bounce.cuh:Lanes).
// Returns cudaGetLastError() after the launch.
extern "C" int rt_trace_unroll(const float* origin, const float* direction,
                               const int32_t* pix, const int32_t* samp,
                               const float* tp_in, const float* alive_in,
                               float* radiance, float* state,
                               int32_t* counters, int n_lanes,
                               const float* tables, const int* dims,
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
  size_t smem = static_cast<size_t>(rt::table_floats(d)) * sizeof(float);
  if (n_lanes > 0) {
    int blocks = (n_lanes + threads - 1) / threads;
    auto kernel = rt::stateful(io, run) ? rt_trace_unroll_state_kernel
                                        : rt_trace_unroll_kernel;
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        io, tables, d, run);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
