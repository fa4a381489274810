// Batched dense lower-triangular block solves (block TRSV / TRSM) for Hopper.
//
// Replaces the Pallas kernels of src/repro/kernels/block_trsv.py:
// _trsv_rowsweep_kernel (one (B,) right-hand side per tile) with
// trsv_rowsweep_kernel, _trsm_rowsweep_kernel (an (B,R) panel per tile)
// with trsm_kernel (B <= 32) and trsm_wide_kernel (B > 32), and
// _trsv_panel_kernel (block_trsv(algorithm="panel"): P rows per step) with
// trsv_panel_kernel. The TPU kernels run one grid program per tile in
// order; here the tiles' CTAs run in parallel, which is legal because the
// tiles are independent.
//
// Arithmetic of the row sweep, kept op for op from the reference: row i
// takes the dot of L[i, :i] with the solved prefix x[:i] (lane l's FMA
// chain over j = l, l + 32, ... from 0.f, then the xor butterfly at offsets
// 16, 8, 4, 2, 1), then x[i] = (r[i] - s) / L[i, i] with an IEEE division.
// The TRSV and trsm_wide_kernel run it from rowsweep.cuh; trsm_kernel runs
// the same operations in registers (sweep_registers), so every TRSM column
// is bit-equal to a TRSV of that column alone. ref.py::rowsweep_bits_ref
// emulates this order for B <= 32.
//
// Bound: the least time for the work is set by bytes (each lower triangle
// read once, at about one flop per byte). The kernels do not approach it:
// each column's solve is a chain of B dependent steps (multiply, reduce,
// divide), so a tile takes the latency of that chain whatever the
// bandwidth. trsm_kernel keeps the chain short: lane l loads column l of
// the tile into registers once, before the sweep, so a step is one FMA,
// five shuffles and adds, a subtraction and a division, with no memory
// access and no __syncwarp; its R columns run on R warps of one CTA. The
// TRSV and trsm_wide_kernel still load row i of L from global memory on
// the chain and pass x through shared memory.
//
// Layout: L (k,B,B), r and x (k,B) or (k,B,R), all row-major float32,
// contiguous. The wrapper checks shapes, dtype, device and contiguity.

#include <cuda_runtime.h>

#include "rowsweep.cuh"

namespace {

using repro::kWarp;
using repro::sweep_column;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxTrsmWarps = 16;  // both TRSM kernels: column warps per CTA

// One warp per tile; x staged in shared memory (B floats).
__global__ void trsv_rowsweep_kernel(const float* __restrict__ L, const float* __restrict__ r,
                                     float* __restrict__ x, int B) {
  extern __shared__ float xs[];
  const size_t t = blockIdx.x;
  const int lane = threadIdx.x;
  for (int i = lane; i < B; i += kWarp) xs[i] = r[t * B + i];
  __syncwarp();
  sweep_column(L + t * B * B, xs, B, lane);
  for (int i = lane; i < B; i += kWarp) x[t * B + i] = xs[i];
}

// B <= 32: lane l's registers for one tile, loaded before the sweep with
// coalesced row loads: Lc[s] = L[s][l] (column l, zero above the diagonal
// and past B) and d = L[l][l] (1 past B).
__device__ __forceinline__ void load_column(const float* __restrict__ Lt, int B, int lane,
                                            float (&Lc)[kWarp], float& d) {
#pragma unroll
  for (int s = 0; s < kWarp; ++s) Lc[s] = lane <= s && s < B ? __ldg(Lt + s * B + lane) : 0.f;
  d = lane < B ? __ldg(Lt + lane * (B + 1)) : 1.f;
}

// The row sweep of one column in registers, B <= 32: lane l holds r[l] and
// returns x[l]. Row i: lane l < i forms L[i][l] * x[l] as sweep_rows does
// (p = 0.f; p += a * b: the same FMA), the butterfly sums the 32 partials,
// and every lane divides (r - s) by its own diagonal; lane i keeps its
// quotient, (r[i] - s) / L[i][i]. The loop is unrolled, so every register
// index is a constant; the i < B test is the same on every lane.
__device__ __forceinline__ float sweep_registers(const float (&Lc)[kWarp], float d, float r, int B,
                                                 int lane) {
  float x = 0.f;
#pragma unroll
  for (int i = 0; i < kWarp; ++i) {
    if (i < B) {
      float p = 0.f;
      if (lane < i) p += Lc[i] * x;
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) p += __shfl_xor_sync(kFull, p, o);
      const float q = __fdiv_rn(r - p, d);
      if (lane == i) x = q;
    }
  }
  return x;
}

// B <= 32: one warp per right-hand-side column (columns strided over the
// CTA's warps); each warp holds the tile in registers (the CTA's first
// load brings it into L1 for the others) and sweeps its column there.
__global__ void __launch_bounds__(kMaxTrsmWarps * kWarp)
    trsm_kernel(const float* __restrict__ L, const float* __restrict__ r, float* __restrict__ x,
                int B, int R) {
  const size_t t = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  float Lc[kWarp], d;
  load_column(L + t * B * B, B, lane, Lc, d);
  const size_t row = (t * B + lane) * R;  // this lane's row of r and x
  for (int c = threadIdx.x / kWarp; c < R; c += blockDim.x / kWarp) {
    const float xc = sweep_registers(Lc, d, lane < B ? __ldg(r + row + c) : 0.f, B, lane);
    if (lane < B) x[row + c] = xc;
  }
}

// B > 32: one warp per right-hand-side column (columns strided over the
// CTA's warps); the panel is staged column-major in shared memory (R*B
// floats) so each column's sweep runs the same code, in the same order, as
// the TRSV kernel: column j of a panel solve equals an independent TRSV bit
// for bit.
__global__ void trsm_wide_kernel(const float* __restrict__ L, const float* __restrict__ r,
                                 float* __restrict__ x, int B, int R) {
  extern __shared__ float xs[];
  const size_t t = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const float* rt = r + t * B * R;
  float* xt = x + t * B * R;
  for (int e = threadIdx.x; e < B * R; e += blockDim.x) xs[(e % R) * B + e / R] = rt[e];
  __syncthreads();
  for (int c = warp; c < R; c += n_warps) sweep_column(L + t * B * B, xs + c * B, B, lane);
  __syncthreads();
  for (int e = threadIdx.x; e < B * R; e += blockDim.x) xt[e] = xs[(e % R) * B + e / R];
}

// The panel forward substitution of _trsv_panel_kernel, one warp per tile:
// for each panel of P rows, rows i in [base, base + P) take the dot of
// L[i, base:i] with the panel's solved prefix (reduced across the warp) and
// x[i] = (r[i] - s) / L[i, i] with an IEEE division; then every row below
// the panel subtracts its rank-P update, one lane per row, a float32 FMA
// chain over the panel's P columns: r[i] -= L[i, base:base+P] . x[base:base+P].
// The running right-hand side r and x live in shared memory (2B floats).
// The summation order is the reference's panel order, not the row sweep's,
// so the result is not bit-equal to trsv_rowsweep_kernel's on real values.
__global__ void trsv_panel_kernel(const float* __restrict__ L, const float* __restrict__ r_in,
                                  float* __restrict__ x_out, int B, int P) {
  extern __shared__ float sm[];
  float* r = sm;
  float* x = sm + B;
  const size_t t = blockIdx.x;
  const int lane = threadIdx.x;
  const float* Lt = L + t * B * B;
  for (int i = lane; i < B; i += kWarp) r[i] = r_in[t * B + i];
  __syncwarp();
  for (int base = 0; base < B; base += P) {
    for (int i = base; i < base + P; ++i) {
      const float* li = Lt + static_cast<size_t>(i) * B;
      float p = 0.f;
      for (int j = base + lane; j < i; j += kWarp) p += li[j] * x[j];
      const float s = repro::warp_sum(p);
      if (lane == 0) x[i] = __fdiv_rn(r[i] - s, li[i]);
      __syncwarp();
    }
    for (int i = base + P + lane; i < B; i += kWarp) {
      const float* li = Lt + static_cast<size_t>(i) * B + base;
      float u = 0.f;
      for (int j = 0; j < P; ++j) u += li[j] * x[base + j];
      r[i] = r[i] - u;
    }
    __syncwarp();
  }
  for (int i = lane; i < B; i += kWarp) x_out[t * B + i] = x[i];
}

// Opts the kernel in to `bytes` of dynamic shared memory. A refusal is
// returned and cleared, so the next launch does not report it.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() of
// the launch (0 on success); it never synchronises.
int repro_trsv_f32(const float* L, const float* r, float* x, int k, int B, void* stream) {
  const size_t smem = static_cast<size_t>(B) * sizeof(float);
  cudaError_t err = allow_shared(trsv_rowsweep_kernel, smem);
  if (err != cudaSuccess) return err;
  trsv_rowsweep_kernel<<<k, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(L, r, x, B);
  return cudaGetLastError();
}

int repro_trsv_panel_f32(const float* L, const float* r, float* x, int k, int B, int P,
                         void* stream) {
  if (P < 1 || B % P != 0) return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(B) * sizeof(float);
  cudaError_t err = allow_shared(trsv_panel_kernel, smem);
  if (err != cudaSuccess) return err;
  trsv_panel_kernel<<<k, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(L, r, x, B, P);
  return cudaGetLastError();
}

int repro_trsm_f32(const float* L, const float* r, float* x, int k, int B, int R, void* stream) {
  const int warps = R < kMaxTrsmWarps ? R : kMaxTrsmWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= kWarp) {
    trsm_kernel<<<k, warps * kWarp, 0, s>>>(L, r, x, B, R);
    return cudaGetLastError();
  }
  const size_t smem = static_cast<size_t>(B) * R * sizeof(float);
  cudaError_t err = allow_shared(trsm_wide_kernel, smem);
  if (err != cudaSuccess) return err;
  trsm_wide_kernel<<<k, warps * kWarp, smem, s>>>(L, r, x, B, R);
  return cudaGetLastError();
}

// Weak: every source defines it, so the sources also link into one module.
__attribute__((weak)) const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
