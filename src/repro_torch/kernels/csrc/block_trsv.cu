// Batched dense lower-triangular block solves (block TRSV / TRSM) for Hopper.
//
// Replaces the Pallas kernels of src/repro/kernels/block_trsv.py:
// _trsv_rowsweep_kernel (one (B,) right-hand side per tile) with
// trsv_kernel (B <= 32) and trsv_rowsweep_kernel (B > 32),
// _trsm_rowsweep_kernel (an (B,R) panel per tile) with trsm_kernel (B <= 32)
// and trsm_wide_kernel (B > 32), and _trsv_panel_kernel
// (block_trsv(algorithm="panel"): P rows per step) with
// trsv_panel_sweep_kernel (B <= 32) and trsv_panel_kernel (B > 32). Each
// entry point picks its kernel by the block size alone: both branches are
// checked on the card, and a launch that is refused raises. The TPU kernels
// run one grid program per tile in order; here the tiles' warps run in
// parallel, which is legal because the tiles are independent.
//
// Arithmetic of the row sweep, kept op for op from the reference: row i
// takes the dot of L[i, :i] with the solved prefix x[:i] (lane l's FMA
// chain over j = l, l + 32, ... from 0.f, then the xor butterfly at offsets
// 16, 8, 4, 2, 1), then x[i] = (r[i] - s) / L[i, i] with an IEEE division.
// trsv_kernel and trsm_kernel run it in registers (sweep_registers), the
// B > 32 kernels from rowsweep.cuh, in the same order, so every TRSM column
// is bit-equal to a TRSV of that column alone. ref.py::rowsweep_bits_ref
// emulates this order for B <= 32.
//
// The panel order (the reference's _trsv_panel_kernel), panel by panel:
// row i of the panel starting at row b takes the products L[i][j] * x[j]
// for j in [b, i) (fmaf(a, x, 0.f), the product for column j on lane j - b,
// +0 on the other lanes), sums them with the butterfly and sets x[i] = (r[i]
// - s) / L[i, i]; after the panel, each row i below it subtracts u, a
// float32 FMA chain from 0.f over the panel's columns in order: r[i] -= u.
// Both panel kernels compute exactly this; ref.py::panel_bits_ref emulates
// it for B <= 32. It sums in another order than the row sweep, so the two
// agree within float32 rounding, not bit for bit.
//
// Bound: the bytes of the work (each lower triangle read once) take ~20 ns
// for the main path's 32 tiles; no forward substitution approaches that.
// Each column's solve is a chain of B dependent steps (products, reduction,
// division), so a tile takes the latency of that chain whatever the
// bandwidth, and at least B times one dependent division and FMA
// (perf/chain_latency.py measures that floor). The B <= 32 kernels keep the
// chain short: each lane loads its entries of the tile into registers once,
// before the sweep, so a step touches no memory and needs no __syncwarp.
// A TRSV or TRSM step is one FMA, five shuffles and adds, a subtraction and
// a division; a panel step is the same, with no butterfly on a panel's
// first row, and the update of the rows below runs beside the sweep: after
// row i every lane adds L[l][i] * x[i] to its chain (one broadcast, one
// FMA), and after a panel's last row the rows below subtract it. One warp
// per tile and one tile per CTA: four tiles per CTA, staging the panel
// kernel's tile through shared memory, and P at run time for every P were
// each slower at the main path's 32 tiles (perf/trsv_variants.py, PERF.md).
// The B > 32 kernels still load row i of L on the chain and pass x through
// shared memory.
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
constexpr int kSweepTiles = 1;     // trsv_kernel, trsv_panel_sweep_kernel: tiles (warps) per CTA

// B > 32: one warp per tile; x staged in shared memory (B floats).
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

// B <= 32: one warp per tile, holding the tile's columns in registers and
// sweeping its right-hand side there: a TRSM column's own operations.
__global__ void __launch_bounds__(kSweepTiles * kWarp)
    trsv_kernel(const float* __restrict__ L, const float* __restrict__ r, float* __restrict__ x,
                int k, int B) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kSweepTiles + threadIdx.x / kWarp;
  if (t >= static_cast<size_t>(k)) return;  // the whole warp
  const int lane = threadIdx.x % kWarp;
  float Lc[kWarp], d;
  load_column(L + t * B * B, B, lane, Lc, d);
  const float xl = sweep_registers(Lc, d, lane < B ? __ldg(r + t * B + lane) : 0.f, B, lane);
  if (lane < B) x[t * B + lane] = xl;
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

// B <= 32: lane l's registers for the panel sweep, loaded before it. With
// b = l - l % P the first row of lane l's panel: A[m] = L[l][m] for m < b
// (row l: its updates from the panels above), A[m] = L[m][l] for l < m <
// b + P (column l: its products in its own panel), 0 elsewhere and on lanes
// past B; d = L[l][l] (1 past B). One load per m, all issued before any
// is used: the column entries are coalesced, the row entries strided across
// lanes (one sector a lane, through L1).
__device__ __forceinline__ void load_panel(const float* __restrict__ Lt, int B, int P, int lane,
                                           float (&A)[kWarp], float& d) {
  const int b = lane - lane % P;
#pragma unroll
  for (int m = 0; m < kWarp; ++m) {
    const bool row = m < b, col = lane < m && m < b + P;
    A[m] = lane < B && (row || col) ? __ldg(Lt + (row ? lane * B + m : m * B + lane)) : 0.f;
  }
  d = lane < B ? __ldg(Lt + lane * (B + 1)) : 1.f;
}

// B <= 32: the panel order in registers, one warp per tile; lane l holds
// r[l], x[l], d and A (load_panel) and u, its row's update chain for the
// current panel. Row i of the panel starting at b: lane j in [b, i) forms
// its product (p = 0.f; p += a * x: fmaf(a, x, 0.f)); where lane j is not
// lane j - b XOR-translated (b has a bit in common with some j - b < P:
// never when P is a power of two), one rotation moves each product to lane
// j - b; the butterfly sums, and every lane divides (r - s) by its own
// diagonal, lane i keeping its quotient. On a panel's first row there is no
// product: s = +0 and r - s = r. Every lane then takes x[i] by one
// broadcast and adds A[i] * x[i] to u (lanes below the panel hold A[i] =
// L[l][i]); after the panel's last row the lanes below it subtract u, and
// u restarts from 0.f. kP > 0 is P fixed at compile time (every guard and
// register index folds); kP = 0 takes P at run time, behind guards that are
// the same on every lane.
template <int kP>
__global__ void __launch_bounds__(kSweepTiles * kWarp)
    trsv_panel_sweep_kernel(const float* __restrict__ L, const float* __restrict__ r_in,
                            float* __restrict__ x_out, int k, int B, int panel) {
  const int P = kP > 0 ? kP : panel;
  const size_t t = static_cast<size_t>(blockIdx.x) * kSweepTiles + threadIdx.x / kWarp;
  if (t >= static_cast<size_t>(k)) return;  // the whole warp
  const int lane = threadIdx.x % kWarp;
  float A[kWarp], d;
  load_panel(L + t * B * B, B, P, lane, A, d);
  float r = lane < B ? __ldg(r_in + t * B + lane) : 0.f;
  float x = 0.f, u = 0.f;
  int span = 1;  // the least power of two >= P
  while (span < P) span *= 2;
  int base = 0;          // first row of row i's panel
  bool rotate = false;   // lane j's product belongs on lane j - base, not j ^ base
#pragma unroll
  for (int i = 0; i < kWarp; ++i) {
    if (i == B) break;
    float q;
    if (i == base) {
      q = __fdiv_rn(r, d);
    } else {
      float p = 0.f;
      if (base <= lane && lane < i) p += A[i] * x;
      if (rotate) p = __shfl_sync(kFull, p, (lane + base) & (kWarp - 1));
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) p += __shfl_xor_sync(kFull, p, o);
      q = __fdiv_rn(r - p, d);
    }
    if (lane == i) x = q;
    u = __fmaf_rn(A[i], __shfl_sync(kFull, q, i), u);
    if (i == base + P - 1) {  // the panel's last row: the rows below take its update
      if (lane > i) r = r - u;
      u = 0.f;
      base = i + 1;
      rotate = (base & (span - 1)) != 0;
    }
  }
  if (lane < B) x_out[t * B + lane] = x;
}

// B > 32: the panel order, one warp per tile: for each panel of P rows,
// rows i in [base, base + P) take the dot of L[i, base:i] with the panel's
// solved prefix (reduced across the warp) and x[i] = (r[i] - s) / L[i, i]
// with an IEEE division; then every row below the panel subtracts its
// rank-P update, one lane per row, a float32 FMA chain over the panel's P
// columns: r[i] -= L[i, base:base+P] . x[base:base+P]. The running
// right-hand side r and x live in shared memory (2B floats).
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= kWarp) {
    trsv_kernel<<<(k + kSweepTiles - 1) / kSweepTiles, kSweepTiles * kWarp, 0, s>>>(L, r, x, k,
                                                                                     B);
    return cudaGetLastError();
  }
  const size_t smem = static_cast<size_t>(B) * sizeof(float);
  cudaError_t err = allow_shared(trsv_rowsweep_kernel, smem);
  if (err != cudaSuccess) return err;
  trsv_rowsweep_kernel<<<k, kWarp, smem, s>>>(L, r, x, B);
  return cudaGetLastError();
}

int repro_trsv_panel_f32(const float* L, const float* r, float* x, int k, int B, int P,
                         void* stream) {
  if (P < 1 || B % P != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= kWarp) {
    const int grid = (k + kSweepTiles - 1) / kSweepTiles, block = kSweepTiles * kWarp;
    switch (P) {  // powers of two with P fixed at compile time, any other P at run time
      case 1: trsv_panel_sweep_kernel<1><<<grid, block, 0, s>>>(L, r, x, k, B, P); break;
      case 2: trsv_panel_sweep_kernel<2><<<grid, block, 0, s>>>(L, r, x, k, B, P); break;
      case 4: trsv_panel_sweep_kernel<4><<<grid, block, 0, s>>>(L, r, x, k, B, P); break;
      case 8: trsv_panel_sweep_kernel<8><<<grid, block, 0, s>>>(L, r, x, k, B, P); break;
      case 16: trsv_panel_sweep_kernel<16><<<grid, block, 0, s>>>(L, r, x, k, B, P); break;
      case 32: trsv_panel_sweep_kernel<32><<<grid, block, 0, s>>>(L, r, x, k, B, P); break;
      default: trsv_panel_sweep_kernel<0><<<grid, block, 0, s>>>(L, r, x, k, B, P);
    }
    return cudaGetLastError();
  }
  const size_t smem = 2 * static_cast<size_t>(B) * sizeof(float);
  cudaError_t err = allow_shared(trsv_panel_kernel, smem);
  if (err != cudaSuccess) return err;
  trsv_panel_kernel<<<k, kWarp, smem, s>>>(L, r, x, B, P);
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
