// One CTA's bulk-copy rate, as the streamed megakernel's row-chunked form
// uses it (src/repro_torch/kernels/csrc/superstep.cu): thread 0 issues
// each chunk's cp.async.bulk one chunk ahead into one of two stages of
// shared memory, each completing its stage's mbarrier; every thread waits
// for the chunk, reads one float of it, and a CTA barrier (then thread 0's
// fence.proxy.async) frees the stage for the chunk after next. Chunk j is
// read from `src` at float (j * chunk) mod (span - chunk), so a span larger
// than the 50 MB L2 streams from device memory and a small one from L2.
// Built by perf/bulk_copy.py with the kernels' own nvcc flags.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void issue(uint32_t dst, const float* src, uint32_t bytes,
                                      uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__global__ void bulk_copy_kernel(const float* src, long long span, int chunk, int n,
                                 float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* stage = reinterpret_cast<float*>(smem + 16);
  const uint32_t bar[2] = {smem_addr(bars), smem_addr(bars + 1)};
  const long long room = span - chunk;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar[i]) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue(smem_addr(stage), src, chunk * 4u, bar[0]);
  }
  __syncthreads();
  float acc = 0.f;
  for (int j = 0; j < n; ++j) {
    if (threadIdx.x == 0 && j + 1 < n)
      issue(smem_addr(stage + ((j + 1) & 1) * chunk),
            src + (static_cast<long long>(j + 1) * chunk) % room, chunk * 4u, bar[(j + 1) & 1]);
    wait(bar[j & 1], (j >> 1) & 1);
    acc += stage[(j & 1) * chunk + threadIdx.x % chunk];
    __syncthreads();
    if (threadIdx.x == 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  out[threadIdx.x] = acc;
}

}  // namespace

// n chunks of `chunk` floats (a multiple of 4) on one CTA of `threads`
// threads; `src` 16-byte aligned, `span` floats long (> chunk).
extern "C" int repro_bulk_copy_f32(const float* src, long long span, int chunk, int n,
                                   int threads, float* out, void* stream) {
  const size_t smem = 16 + 2 * 4 * static_cast<size_t>(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      bulk_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bulk_copy_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(src, span, chunk, n,
                                                                           out);
  return cudaGetLastError();
}
