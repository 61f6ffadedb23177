// P1: the dependent-row copy probe.
//
// Replaces tools/measure_dma_stream.py:make_kernel (:23) -> pl.pallas_call
// (:67), the TPU probe that sized what a stream-kernel leaf visit costs: a
// serial chain of n_steps copies of a data-dependent table row from
// device memory into fast memory, each waited for before the next index
// is known. Plain version: tools/measure_dma_stream.py:chain_plain (the
// port's copy of the tool).
//
// Each step: v0 = row[idx][0], v1 = row[idx][last]; acc = (acc + v0) + v1
// in float32; idx = floor_mod(int32(idx * 1664525 + 1013904223 +
// int32(v0)), n_rows), the int32 product wrapping. The only float
// arithmetic is that chain of adds, so every variant returns the plain
// version's acc bit for bit.
//
// Three ways for a Hopper SM to bring a row in, the counterparts of the
// TPU's async copy into scalar or vector memory with a semaphore wait:
//   ld        one thread reads v0 and v1 through the read-only cache
//             (__ldg), as K5 reads its leaf rows;
//   cp_async  one warp copies the row into shared memory, 16 B a thread
//             (cp.async.cg), waits (cp.async.wait_all, __syncwarp) and
//             reads it there;
//   tma       one thread issues one bulk copy of the row (cp.async.bulk)
//             that completes on an mbarrier in shared memory, and waits on
//             the barrier's phase.
// What bounds it: latency, by construction. One block runs one chain
// (the TPU probe is a grid of one); each step's address depends on the
// previous step's data, so nothing overlaps, and ns per step is one round
// trip to where the row lies (L1, L2 or HBM) plus the copy's issue and
// completion.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int next_row(int idx, float v0, int n_rows) {
  uint32_t t = static_cast<uint32_t>(idx) * 1664525u + 1013904223u +
               static_cast<uint32_t>(static_cast<int32_t>(v0));
  int32_t r = static_cast<int32_t>(t) % n_rows;  // C's %: toward zero
  return r < 0 ? r + n_rows : r;                 // floor modulo
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

}  // namespace

extern "C" __global__ void rt_dma_probe_ld_kernel(
    const float* __restrict__ tab, int n_rows, int row_floats, int n_steps,
    int seed, float* __restrict__ out) {
  if (threadIdx.x != 0) return;
  int idx = seed;
  float acc = 0.0f;
  for (int i = 0; i < n_steps; ++i) {
    const float* row = tab + static_cast<size_t>(idx) * row_floats;
    float v0 = __ldg(row);
    float v1 = __ldg(row + row_floats - 1);
    acc = (acc + v0) + v1;
    idx = next_row(idx, v0, n_rows);
  }
  out[0] = acc;
}

extern "C" __global__ void rt_dma_probe_cp_async_kernel(
    const float* __restrict__ tab, int n_rows, int row_floats, int n_steps,
    int seed, float* __restrict__ out) {
  extern __shared__ __align__(16) float probe_row[];
  const int lane = threadIdx.x;  // one warp
  const int chunks = row_floats / 4;
  int idx = seed;
  float acc = 0.0f;
  for (int i = 0; i < n_steps; ++i) {
    const float* row = tab + static_cast<size_t>(idx) * row_floats;
    for (int c = lane; c < chunks; c += 32)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(probe_row + 4 * c)),
                   "l"(row + 4 * c)
                   : "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    float v0 = probe_row[0];
    float v1 = probe_row[row_floats - 1];
    __syncwarp();  // every read is done before the next copy lands
    acc = (acc + v0) + v1;
    idx = next_row(idx, v0, n_rows);
  }
  if (lane == 0) out[0] = acc;
}

extern "C" __global__ void rt_dma_probe_tma_kernel(
    const float* __restrict__ tab, int n_rows, int row_floats, int n_steps,
    int seed, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char probe_buf[];
  if (threadIdx.x != 0) return;
  const uint32_t bar = smem_addr(probe_buf);        // the mbarrier, 8 B
  const float* row_s = reinterpret_cast<const float*>(probe_buf + 16);
  const uint32_t dst = smem_addr(row_s);
  const uint32_t bytes = static_cast<uint32_t>(row_floats) * 4u;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  uint32_t phase = 0;
  int idx = seed;
  float acc = 0.0f;
  for (int i = 0; i < n_steps; ++i) {
    const float* row = tab + static_cast<size_t>(idx) * row_floats;
    // the last step's reads of the buffer (generic proxy) before this
    // copy's writes (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(row), "r"(bytes), "r"(bar)
        : "memory");
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(phase)
          : "memory");
    }
    phase ^= 1u;
    float v0 = row_s[0];
    float v1 = row_s[row_floats - 1];
    acc = (acc + v0) + v1;
    idx = next_row(idx, v0, n_rows);
  }
  out[0] = acc;
}

// Launch P1's variant (0 ld, 1 cp_async, 2 tma) on `stream`: one block of
// one warp. tab: [n_rows][row_floats] floats, 16-byte aligned rows
// (row_floats a multiple of 4) for the copies; seed: the first row.
// Returns cudaGetLastError() after the launch.
extern "C" int rt_dma_probe(const float* tab, int n_rows, int row_floats,
                            int n_steps, int seed, int variant, float* out,
                            void* stream) {
  auto kernel = variant == 0   ? rt_dma_probe_ld_kernel
                : variant == 1 ? rt_dma_probe_cp_async_kernel
                               : rt_dma_probe_tma_kernel;
  size_t smem = variant == 0 ? 0 : static_cast<size_t>(row_floats) * 4 + 16;
  kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      tab, n_rows, row_floats, n_steps, seed, out);
  return static_cast<int>(cudaGetLastError());
}
