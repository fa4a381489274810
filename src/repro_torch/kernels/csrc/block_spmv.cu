// Batched per-tile products (block GEMV / GEMM) for Hopper.
//
// Replaces the Pallas kernels of src/repro/kernels/block_spmv.py:
// _gemv_kernel (tiles (m,B,B) @ xs (m,B)) and _gemv_grouped_kernel (the
// same product, G tiles per program) with gemv_grouped_kernel (the GEMV is
// its G = 1 launch), and _gemm_kernel (tiles (m,B,B) @ xs (m,B,R)) with
// gemm_kernel (B <= 32) and gemm_wide_kernel (B > 32). The scatter-add of
// the products into destination rows stays outside the kernel, as in the
// reference.
//
// The bits, the family's definition: every output of all three kernels is
// summed the same way. Lane l forms its partial from 0.f with an FMA chain
// over the columns j = l, l + 32, ... in increasing order (lanes with l >= B
// hold 0), then the xor butterfly combines the 32 partials with offsets 16,
// 8, 4, 2, 1, each lane adding its partner's value. IEEE addition is
// commutative, so every lane ends with the same bits. Only float32 FMAs and
// adds: no tensor cores and no TF32, which would change the bits the
// exact-arithmetic parity tests compare. ref.py::gemv_bits_ref emulates
// this order for B <= 32, and the card tests hold every kernel to it.
//
// The transpose-reduce (transpose_reduce) does that butterfly for 32 rows
// at once. Lane l holds its partials v[0..31] of 32 rows. At offset o it
// keeps half of the rows it holds and hands the other half to lane l ^ o,
// adding what it receives for the rows it keeps. A row's value at lane l
// after offset o is the sum of its values at lanes l and l ^ o before it,
// exactly as in the butterfly, so every row meets the same pairs in the
// same order and ends with the butterfly's bits. Lane -> row map: at
// offset o lane l keeps the upper half of its rows when bit o of l is set,
// the lower half when it is clear, so after offset 1 lane l holds row l of
// the 32 (row row0 + l of the tile), and that lane stores it: one
// coalesced 128-byte store. Picking the half to keep costs two selects per
// shuffle; gemm_kernel, which reuses one tile for every column, permutes
// its registers once into xor order (slot s holds row s ^ l) and needs
// none, with the same map at the end. The cost is 31 shuffles and 31 adds
// per lane for 32 rows, where a butterfly per row takes 160 of each, and
// the 32 row loads are independent coalesced 128-byte segments, not 32
// serial chains.
//
// What bounds them on an H100 (PERF.md): at the IC(0)-PCG SpMV's tile count
// (m = 15,857, B = 32) the tiles' bytes, 4 KB a tile read once (0.021 ms at
// 3.35 TB/s for a vector, 0.029 ms with R = 8 panels); at the main path's
// widest level (m = 64) latency: one tile's loads, then the reduction's
// dependent shuffle steps, on a few dozen warps. For B > 32,
// gemm_wide_kernel re-reads each 32-row block from L1 or L2 once per
// 4-column pass.
//
// Layout: tiles (m,B,B), xs and out (m,B) or (m,B,R), row-major float32,
// contiguous. The wrapper checks shapes, dtype, device and contiguity.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGemvTiles = 1;       // repro_gemv_f32: tiles per gemv_grouped_kernel CTA
constexpr int kMaxGroupWarps = 16;  // gemv_grouped_kernel: larger groups stride over these;
                                    // 512 threads leave a thread 128 registers
constexpr int kGemmWarps = 4;       // both GEMM kernels: tiles per CTA, one warp each
constexpr int kCols = 8;            // gemm_kernel, B <= 32: right-hand-side columns per pass
constexpr int kRowCols = 4;         // gemm_wide_kernel: columns per pass over a row block

// One offset o of the transpose-reduce: lane l keeps slots 0 .. o-1 and
// adds to each what lane l ^ o sends from its slots o .. 2o-1. With rows in
// natural order (kXorSlots false) slot k holds row k and slot k + o row
// k + o, so a lane with bit o set first swaps the two (two selects per
// shuffle); with kXorSlots the slots already hold rows in that order.
template <int O, bool kXorSlots>
__device__ __forceinline__ void reduce_step(float (&v)[kWarp], int lane) {
  const bool upper = !kXorSlots && (lane & O) != 0;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = upper ? v[k] : v[k + O];
    const float keep = upper ? v[k + O] : v[k];
    v[k] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, O));
  }
}

// The butterfly for 32 rows at once. v[s] holds this lane's partial of row
// s (kXorSlots: of row s ^ lane); returns the full sum of row `lane`. A
// step per offset, each a template, so every slot index is a constant and
// v stays in registers.
template <bool kXorSlots>
__device__ __forceinline__ float transpose_reduce(float (&v)[kWarp], int lane) {
  reduce_step<16, kXorSlots>(v, lane);
  reduce_step<8, kXorSlots>(v, lane);
  reduce_step<4, kXorSlots>(v, lane);
  reduce_step<2, kXorSlots>(v, lane);
  reduce_step<1, kXorSlots>(v, lane);
  return v[0];
}

// Puts natural-order slots into xor order one bit at a time: a lane with
// bit O set swaps slot s and slot s | O for every s without that bit.
template <int O>
__device__ __forceinline__ void xor_swap(float (&v)[kWarp], int lane) {
  const bool swap = (lane & O) != 0;
#pragma unroll
  for (int s = 0; s < kWarp; ++s)
    if (!(s & O)) {
      const float a = v[s], b = v[s | O];
      v[s] = swap ? b : a;
      v[s | O] = swap ? a : b;
    }
}

// One warp, rows row0 .. row0 + 31 of the (B,B) tile T against N vectors:
// element j of vector c at x[j * xs + c]. Lane l sets y[c] to row row0 + l's
// sum against vector c, with the family's bits for that vector alone. Rows
// at or past B re-read the tile's last row, so every load is unconditional;
// their sums are never stored. Each 32-column chunk issues
// its 32 row loads before the FMAs that use them, and each loaded element
// serves all N vectors.
template <int N>
__device__ __forceinline__ void warp_rows_dot(const float* __restrict__ T,
                                              const float* __restrict__ x, int xs, int B,
                                              int row0, int lane, float (&y)[N]) {
  float v[N][kWarp];
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int s = 0; s < kWarp; ++s) v[c][s] = 0.f;
  const int last = min(kWarp, B - row0) - 1;
  const float* Tr = T + static_cast<size_t>(row0) * B;
  for (int k0 = 0; k0 < B; k0 += kWarp) {  // every lane walks every chunk: the shuffles need 32
    const int j = k0 + lane;
    if (j < B) {
      float xj[N], tv[kWarp];
#pragma unroll
      for (int c = 0; c < N; ++c) xj[c] = __ldg(x + static_cast<size_t>(j) * xs + c);
#pragma unroll
      for (int s = 0; s < kWarp; ++s) tv[s] = __ldg(Tr + min(s, last) * B + j);
#pragma unroll
      for (int s = 0; s < kWarp; ++s)
#pragma unroll
        for (int c = 0; c < N; ++c) v[c][s] = __fmaf_rn(tv[s], xj[c], v[c][s]);
    }
  }
#pragma unroll
  for (int c = 0; c < N; ++c) y[c] = transpose_reduce<false>(v[c], lane);
}

// G tiles per CTA, one warp per tile (tiles strided over at most
// kMaxGroupWarps warps when G is larger); the warp takes its tile 32 rows at
// a time through warp_rows_dot, and lane l stores row row0 + l: a coalesced
// 128-byte store. The last CTA checks its tiles against m instead of
// reading padded copies. The GEMV (repro_gemv_f32) is its launch with
// kGemvTiles tiles per CTA.
__global__ void __launch_bounds__(kMaxGroupWarps * kWarp)
    gemv_grouped_kernel(const float* __restrict__ T, const float* __restrict__ xv,
                        float* __restrict__ y, int m, int B, int G) {
  const int lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const size_t first = static_cast<size_t>(blockIdx.x) * G;
  for (int g = threadIdx.x / kWarp; g < G; g += n_warps) {
    const size_t t = first + g;
    if (t >= static_cast<size_t>(m)) break;
    const float* Tt = T + t * B * B;
    const float* xt = xv + t * B;
    for (int row0 = 0; row0 < B; row0 += kWarp) {
      float s[1];
      warp_rows_dot<1>(Tt, xt, 1, B, row0, lane, s);
      if (row0 + lane < B) y[t * B + row0 + lane] = s[0];
    }
  }
}

// Lane's values of n <= kCols consecutive columns at src (zeros past n);
// vec: n is a multiple of 4 and src 16-byte aligned, so float4 accesses.
__device__ __forceinline__ void load_cols(const float* __restrict__ src, int n, bool vec,
                                          float (&v)[kCols]) {
#pragma unroll
  for (int h = 0; h < kCols; h += 4) {
    if (vec) {
      const float4 q = h < n ? __ldg(reinterpret_cast<const float4*>(src + h))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      v[h] = q.x, v[h + 1] = q.y, v[h + 2] = q.z, v[h + 3] = q.w;
    } else {
#pragma unroll
      for (int i = h; i < h + 4; ++i) v[i] = i < n ? __ldg(src + i) : 0.f;
    }
  }
}

__device__ __forceinline__ void store_cols(float* __restrict__ dst, int n, bool vec,
                                           const float (&v)[kCols]) {
#pragma unroll
  for (int h = 0; h < kCols; h += 4) {
    if (vec) {
      if (h < n) *reinterpret_cast<float4*>(dst + h) = make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
    } else {
#pragma unroll
      for (int i = h; i < h + 4; ++i)
        if (i < n) dst[i] = v[i];
    }
  }
}

// B <= 32: one warp per tile, kGemmWarps tiles per CTA. Lane l loads
// column l of its tile into registers once (coalesced row loads, tr[s] =
// T[s][l]) and puts them in xor order (slot s holds row s ^ l: five rounds
// of conditional swaps, once per tile), so each right-hand-side column then
// costs 32 FMAs and a select-free transpose_reduce. Lane l reads its row of
// X, kCols columns at a time (two float4 loads when R % 4 == 0), and writes
// row l of Y the same way. Column c of the result has the bits the GEMV
// gives for X[..., c] alone.
__global__ void __launch_bounds__(kGemmWarps * kWarp)
    gemm_kernel(const float* __restrict__ T, const float* __restrict__ X, float* __restrict__ Y,
                int m, int B, int R, bool vec) {
  const int lane = threadIdx.x % kWarp;
  const size_t t = static_cast<size_t>(blockIdx.x) * kGemmWarps + threadIdx.x / kWarp;
  if (t >= static_cast<size_t>(m)) return;  // the whole warp
  const float* Xt = X + t * B * R;
  float* Yt = Y + t * B * R;
  const bool mine = lane < B;  // lane l owns column l of the tile and row l of the result
  float tr[kWarp];
#pragma unroll
  for (int s = 0; s < kWarp; ++s) tr[s] = mine && s < B ? __ldg(T + t * B * B + s * B + lane) : 0.f;
  xor_swap<16>(tr, lane);
  xor_swap<8>(tr, lane);
  xor_swap<4>(tr, lane);
  xor_swap<2>(tr, lane);
  xor_swap<1>(tr, lane);
  for (int c0 = 0; c0 < R; c0 += kCols) {
    const int n = min(kCols, R - c0);
    float xr[kCols] = {}, yr[kCols] = {};
    if (mine) load_cols(Xt + static_cast<size_t>(lane) * R + c0, n, vec, xr);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      if (i < n) {
        float v[kWarp];
#pragma unroll
        for (int s = 0; s < kWarp; ++s) v[s] = __fmaf_rn(tr[s], xr[i], 0.f);
        yr[i] = transpose_reduce<true>(v, lane);
      }
    }
    if (mine) store_cols(Yt + static_cast<size_t>(lane) * R + c0, n, vec, yr);
  }
}

// Rows row0 .. row0 + 31 of tile Tt against N columns c0 .. c0 + N - 1 of
// its X block Xt; lane l stores row row0 + l.
template <int N>
__device__ __forceinline__ void gemm_rows(const float* __restrict__ Tt,
                                          const float* __restrict__ Xt, float* __restrict__ Yt,
                                          int B, int R, int row0, int c0, int lane) {
  float s[N];
  warp_rows_dot<N>(Tt, Xt + c0, R, B, row0, lane, s);
  if (row0 + lane < B)
#pragma unroll
    for (int c = 0; c < N; ++c) Yt[static_cast<size_t>(row0 + lane) * R + c0 + c] = s[c];
}

// B > 32: the rows do not fit a lane's registers. One warp per tile, as
// gemm_kernel; the warp takes each 32-row block through warp_rows_dot
// kRowCols columns at a time (the rest one at a time), so the block is
// re-read from L1 or L2 once per pass, not once per column. A kernel of its
// own, so that its larger register file (kRowCols x 32 partials) does not
// lower gemm_kernel's occupancy. Column c has the GEMV's bits.
__global__ void __launch_bounds__(kGemmWarps * kWarp)
    gemm_wide_kernel(const float* __restrict__ T, const float* __restrict__ X,
                     float* __restrict__ Y, int m, int B, int R) {
  const int lane = threadIdx.x % kWarp;
  const size_t t = static_cast<size_t>(blockIdx.x) * kGemmWarps + threadIdx.x / kWarp;
  if (t >= static_cast<size_t>(m)) return;  // the whole warp
  const float* Tt = T + t * B * B;
  const float* Xt = X + t * B * R;
  float* Yt = Y + t * B * R;
  for (int row0 = 0; row0 < B; row0 += kWarp) {
    int c0 = 0;
    for (; c0 + kRowCols <= R; c0 += kRowCols)
      gemm_rows<kRowCols>(Tt, Xt, Yt, B, R, row0, c0, lane);
    for (; c0 < R; ++c0) gemm_rows<1>(Tt, Xt, Yt, B, R, row0, c0, lane);
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() of
// the launch (0 on success); it never synchronises.
int repro_gemv_grouped_f32(const float* T, const float* x, float* y, int m, int B, int G,
                           void* stream) {
  if (G < 1) return cudaErrorInvalidValue;
  const int warps = G < kMaxGroupWarps ? G : kMaxGroupWarps;
  gemv_grouped_kernel<<<(m + G - 1) / G, warps * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      T, x, y, m, B, G);
  return cudaGetLastError();
}

int repro_gemv_f32(const float* T, const float* x, float* y, int m, int B, void* stream) {
  return repro_gemv_grouped_f32(T, x, y, m, B, kGemvTiles, stream);
}

int repro_gemm_f32(const float* T, const float* X, float* Y, int m, int B, int R, void* stream) {
  const int grid = (m + kGemmWarps - 1) / kGemmWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > kWarp) {
    gemm_wide_kernel<<<grid, kGemmWarps * kWarp, 0, s>>>(T, X, Y, m, B, R);
  } else {
    const bool vec = R % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(Y)) % 16 == 0;
    gemm_kernel<<<grid, kGemmWarps * kWarp, 0, s>>>(T, X, Y, m, B, R, vec);
  }
  return cudaGetLastError();
}

// Weak: every source defines it, so the sources also link into one module.
__attribute__((weak)) const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
