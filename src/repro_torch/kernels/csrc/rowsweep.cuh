// Device functions of the row-sweep kernels for blocks wider than a warp
// (block_trsv.cu, B > 32: trsv_rowsweep_kernel, trsm_wide_kernel, and
// warp_sum in trsv_panel_kernel), so each solves a diagonal tile with the
// same instructions in the same order. At B <= 32 the TRSV, the TRSM and the
// panel TRSV sweep in registers (block_trsv.cu) and use none of this; the
// superstep megakernel (superstep.cu) solves its diagonal tiles with a
// column sweep of its own.
//
// Arithmetic, kept op for op from the reference's row sweep
// (src/repro/kernels/block_trsv.py::_trsv_rowsweep_kernel): row i takes the
// dot of L[i, :i] with the solved prefix x[:i], reduced across the 32 lanes
// of a warp, then x[i] = (r[i] - s) / L[i, i] with an IEEE division.

#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kWarp = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [i0, i1) of a forward substitution of one column held in shared
// memory: xc holds the right-hand side on entry and the solution on exit
// (rows before i0 already solved). L points at row i0 of a lower-triangular
// tile stored by rows ld floats apart, in global or shared memory. Only
// lane 0 writes xc[i]; __syncwarp orders that write before the next row's
// reads.
__device__ __forceinline__ void sweep_rows(const float* __restrict__ L, int ld, int i0, int i1,
                                           float* xc, int lane) {
  for (int i = i0; i < i1; ++i) {
    const float* li = L + static_cast<size_t>(i - i0) * ld;
    float p = 0.f;
    for (int j = lane; j < i; j += kWarp) p += li[j] * xc[j];
    const float s = warp_sum(p);
    if (lane == 0) xc[i] = __fdiv_rn(xc[i] - s, li[i]);
    __syncwarp();
  }
}

// The whole column: all B rows of the tile Lt.
__device__ __forceinline__ void sweep_column(const float* __restrict__ Lt, float* xc,
                                             int B, int lane) {
  sweep_rows(Lt, B, 0, B, xc, lane);
}

}  // namespace repro
