// Batched per-tile products (block GEMV / GEMM) for Hopper.
//
// Replaces the Pallas kernels of src/repro/kernels/block_spmv.py:
// _gemv_kernel (tiles (m,B,B) @ xs (m,B)), _gemv_grouped_kernel (the same
// product, G tiles per program; see gemv_grouped_kernel) and _gemm_kernel
// (tiles (m,B,B) @ xs (m,B,R)). The scatter-add of the products into
// destination rows stays outside the kernel, as in the reference.
//
// One CTA per tile, four warps; each warp takes rows i = warp, warp + 4, ...
// and its lanes stride over the row, so the tile is read with coalesced
// 128-byte row segments and every element exactly once per right-hand-side
// column (from L1 after the first). Products are plain float32 FMAs reduced
// across the warp: no tensor cores and no TF32, which would change the bits
// the exact-arithmetic parity tests compare.
//
// Bound: each tile is read once and used for 2*B*B*R flops, so at the
// solver's widths (B = 32, R <= 8) the least time is set by the bytes of the
// tiles. The design reads each tile row as one coalesced segment; the GEMM
// re-reads it from L1 once per column and reduces each output across a warp,
// which costs more than the bytes at R = 8 (PERF.md) — a register-tiled
// product is the later step.
//
// Layout: tiles (m,B,B), xs and out (m,B) or (m,B,R), row-major float32,
// contiguous. The wrapper checks shapes, dtype, device and contiguity.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerTile = 4;
constexpr int kMaxGroupWarps = 32;  // 1024 threads: the most a CTA may have

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void gemv_kernel(const float* __restrict__ T, const float* __restrict__ xv,
                            float* __restrict__ y, int B) {
  const size_t t = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const float* Tt = T + t * B * B;
  const float* xt = xv + t * B;
  for (int i = threadIdx.x / kWarp; i < B; i += kWarpsPerTile) {
    const float* ti = Tt + static_cast<size_t>(i) * B;
    float p = 0.f;
    for (int j = lane; j < B; j += kWarp) p += __ldg(ti + j) * __ldg(xt + j);
    p = warp_sum(p);
    if (lane == 0) y[t * B + i] = p;
  }
}

// G tiles per CTA, one warp per tile (tiles strided over the CTA's warps
// when G > 32); each warp computes its tile's rows in order with
// gemv_kernel's per-row arithmetic (lanes stride the row, then a warp
// reduction), so every output is bit-equal to gemv_kernel's. The last CTA
// checks its tiles against m instead of reading padded copies.
__global__ void gemv_grouped_kernel(const float* __restrict__ T, const float* __restrict__ xv,
                                    float* __restrict__ y, int m, int B, int G) {
  const int lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const size_t first = static_cast<size_t>(blockIdx.x) * G;
  for (int g = threadIdx.x / kWarp; g < G; g += n_warps) {
    const size_t t = first + g;
    if (t >= static_cast<size_t>(m)) break;
    const float* Tt = T + t * B * B;
    const float* xt = xv + t * B;
    for (int i = 0; i < B; ++i) {
      const float* ti = Tt + static_cast<size_t>(i) * B;
      float p = 0.f;
      for (int j = lane; j < B; j += kWarp) p += __ldg(ti + j) * __ldg(xt + j);
      p = warp_sum(p);
      if (lane == 0) y[t * B + i] = p;
    }
  }
}

// The (B,R) panel is staged column-major in shared memory (R*B floats), so
// the lanes of a warp read consecutive addresses; column c of the result is
// computed in the same order as gemv_kernel would compute it alone.
__global__ void gemm_kernel(const float* __restrict__ T, const float* __restrict__ X,
                            float* __restrict__ Y, int B, int R) {
  extern __shared__ float xs[];
  const size_t t = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const float* Tt = T + t * B * B;
  const float* Xt = X + t * B * R;
  float* Yt = Y + t * B * R;
  for (int e = threadIdx.x; e < B * R; e += blockDim.x) xs[(e % R) * B + e / R] = Xt[e];
  __syncthreads();
  for (int i = threadIdx.x / kWarp; i < B; i += kWarpsPerTile) {
    const float* ti = Tt + static_cast<size_t>(i) * B;
    for (int c = 0; c < R; ++c) {
      const float* xc = xs + c * B;
      float p = 0.f;
      for (int j = lane; j < B; j += kWarp) p += __ldg(ti + j) * xc[j];
      p = warp_sum(p);
      if (lane == 0) Yt[static_cast<size_t>(i) * R + c] = p;
    }
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() of
// the launch (0 on success); it never synchronises.
int repro_gemv_f32(const float* T, const float* x, float* y, int m, int B, void* stream) {
  gemv_kernel<<<m, kWarpsPerTile * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(T, x, y, B);
  return cudaGetLastError();
}

int repro_gemv_grouped_f32(const float* T, const float* x, float* y, int m, int B, int G,
                           void* stream) {
  if (G < 1) return cudaErrorInvalidValue;
  const int warps = G < kMaxGroupWarps ? G : kMaxGroupWarps;
  gemv_grouped_kernel<<<(m + G - 1) / G, warps * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      T, x, y, m, B, G);
  return cudaGetLastError();
}

int repro_gemm_f32(const float* T, const float* X, float* Y, int m, int B, int R, void* stream) {
  const size_t smem = static_cast<size_t>(B) * R * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return err;
    }
  }
  gemm_kernel<<<m, kWarpsPerTile * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      T, X, Y, B, R);
  return cudaGetLastError();
}

// Weak: every source defines it, so the sources also link into one module.
__attribute__((weak)) const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
