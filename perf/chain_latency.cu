// The floor of a forward substitution on the card: x[i] depends on x[i-1]
// through at least one IEEE division and one FMA, whatever the design, so
// a B-row solve takes at least B times their dependent latency. One warp
// runs n steps of that chain (x = r / d, r = fmaf(a, x, c)) with values
// that stay normal (r tends to 1 for d = 2, a = -1, c = 1.5), so every
// division takes __fdiv_rn's common path, as the solves' divisions do.
// Built by perf/chain_latency.py with the kernels' own nvcc flags.

#include <cuda_runtime.h>

namespace {

__global__ void chain_kernel(const float* __restrict__ in, float* __restrict__ out, int n) {
  float r = in[0];
  const float d = in[1], a = in[2], c = in[3];
  for (int s = 0; s < n; ++s) {
    const float x = __fdiv_rn(r, d);
    r = __fmaf_rn(a, x, c);
  }
  out[threadIdx.x] = r;
}

}  // namespace

extern "C" int repro_chain_f32(const float* in, float* out, int n, void* stream) {
  chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return cudaGetLastError();
}
