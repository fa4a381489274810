// The resident superstep megakernel for Hopper: a whole single-device solve
// in one cooperative launch.
//
// Replaces src/repro/kernels/superstep.py::_superstep_kernel in its resident
// form (superstep_call(stream=False), split_delta=False). For each level of
// the launch's superstep range, in order, the reference solves the level's
// rows with rhs = b - acc, then applies the level's tile updates
// acc[trow] += tile @ x[tcol]. It is correct on the TPU because the grid
// programs run one after another on one core; CUDA blocks do not, so the
// port is one persistent, cooperative kernel:
//
// * Co-residency: the kernel is launched with cudaLaunchCooperativeKernel,
//   which refuses a grid that cannot be resident all at once. The entry
//   point returns that refusal (or a device without cooperative launch)
//   as an error; it never spins over a grid that might not be resident.
// * Levels are separated by cooperative_groups' grid barrier. A level with
//   no solve slots writes nothing, so its barrier is skipped; the level
//   widths are read by every thread, so every CTA skips the same barriers.
//   Every CTA reaches every other barrier: no thread returns early, and pad
//   slots (sr = -1) only skip work inside the level.
// * Pull, not push: the host builds, once per plan, each solved row's list
//   of incoming tiles in the order the reference adds them (level, then
//   position in the flat update schedule; kernels/superstep.py::
//   superstep_table). The warp that solves row r at level t sums them into
//   acc[r], starting from the incoming carry, right before it solves. No
//   floating-point atomics and one barrier per level: a real-valued solve
//   gives the same bits run after run. Rows that receive updates but are not
//   solved in the launch ("orphans") are summed after the last level. Updates
//   into the pad row (the zero pad tile) are not applied.
// * x written by another CTA is read with __ldcg (L2, never a stale L1
//   line) after the barrier that follows its level.
//
// Work items are (solve slot, right-hand-side column) pairs, one warp each,
// so column c of an (n, R) panel runs exactly the vector solve's code on
// column c. A warp stages each tile (up to kStage floats of it at a time)
// into its shared buffer with all of its loads in flight at once, then
// computes from there: the stores are too large to stay in L2, and a load
// per tile row would put a memory latency on the chain B times. Tile
// products are float32 FMAs (no TF32, no tensor cores), one lane per tile
// row, summed over the row in column order; the diagonal solve is
// rowsweep.cuh's sweep, shared with block_trsv.cu.
//
// Bound: the bytes of the stores (diagonal tiles and update tiles, each read
// once) over the memory rate. The kernel is far from it: a solve is a chain
// of dependent levels, each a grid barrier, the pulls of the level's rows
// and a B-step row sweep, so its time is set by that latency chain (PERF.md).
//
// Layout: b, acc, x (n_rows, B, R) row-major float32 (R = 1 for vectors),
// diag (n_rows, B, B), tiles (ML+1, B, B); int32 tables. The wrapper
// (kernels/superstep.py) checks shapes, dtype, device and contiguity.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rowsweep.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::kWarp;
using repro::sweep_rows;

constexpr int kWarpsPerCta = 8;
constexpr int kThreads = kWarpsPerCta * kWarp;
constexpr int kStage = 33 * kWarp;  // staging floats per warp: a B = 32 tile, rows padded

struct Args {
  const int* off;         // (T, 3) level offsets into the flats
  const int* wid;         // (T, 3) level widths
  const int* sr;          // (S,) solve rows, pad -1
  const int* pull_ptr;    // (S + n_orphans + 1,) incoming-tile ranges per target
  const int* pull_tile;   // incoming tile ids, in the reference's order
  const int* pull_col;    // the source block row (tcol) of each incoming tile
  const int* orphan_row;  // (n_orphans,) rows updated but not solved
  const int* copy_row;    // (n_copy,) rows not solved: they keep the incoming x
  const float* diag;
  const float* tiles;
  const float* b;
  const float* acc_in;
  const float* x_in;
  float* acc;
  float* x;
  int t_lo, t_hi;  // level range of the launch
  int B, R, S, n_orphans, n_copy;
};

// Per warp: a staging buffer of kStage floats, the row's sum (B) and the
// tile's source column (B).
size_t shared_bytes(int B) { return sizeof(float) * kWarpsPerCta * (kStage + 2 * B); }

// Tile rows staged at once: rows padded to B + 1 floats must fit kStage.
__device__ __forceinline__ int chunk_rows(int B) {
  const int rows = kStage / (B + 1);
  return rows < B ? rows : B;
}

// Copies the first `rows` rows of a row-major tile with B columns from
// global memory into the warp's shared buffer, rows B + 1 floats apart, so
// a lane per row and a lane per column both read without bank conflicts.
// Every load of a lane is issued before its first store: the copy costs one
// memory latency, not one per row.
__device__ __forceinline__ void stage(const float* __restrict__ src, float* dst, int rows,
                                      int B, int lane) {
  const int n = rows * B;
  float v[kStage / kWarp];
#pragma unroll
  for (int u = 0; u < kStage / kWarp; ++u) {
    const int e = lane + u * kWarp;
    v[u] = e < n ? __ldg(src + e) : 0.f;
  }
  int r = lane / B, c = lane % B;
#pragma unroll
  for (int u = 0; u < kStage / kWarp; ++u) {
    if (lane + u * kWarp < n) dst[r * (B + 1) + c] = v[u];
    for (c += kWarp; c >= B; c -= B) ++r;
  }
  __syncwarp();
}

// acc[row, :, c] = acc_in[row, :, c] + sum of the target's incoming tile
// products, tile by tile in table order; the sum is left in s (B floats).
// Each lane computes whole rows of a product (a float32 FMA chain over j).
__device__ void pull(const Args& a, int target, int row, int c, float* buf, float* s,
                     float* xc, int lane) {
  const int B = a.B, R = a.R, chunk = chunk_rows(B);
  for (int j = lane; j < B; j += kWarp)
    s[j] = __ldg(a.acc_in + (static_cast<size_t>(row) * B + j) * R + c);
  const int p1 = __ldg(a.pull_ptr + target + 1);
  for (int p = __ldg(a.pull_ptr + target); p < p1; ++p) {
    const float* T = a.tiles + static_cast<size_t>(__ldg(a.pull_tile + p)) * B * B;
    const float* xv = a.x + static_cast<size_t>(__ldg(a.pull_col + p)) * B * R + c;
    for (int i0 = 0; i0 < B; i0 += chunk) {
      const int i1 = i0 + chunk < B ? i0 + chunk : B;
      __syncwarp();  // the previous chunk's reads of buf, xc and s are done
      if (i0 == 0)
        for (int j = lane; j < B; j += kWarp) xc[j] = __ldcg(xv + static_cast<size_t>(j) * R);
      stage(T + static_cast<size_t>(i0) * B, buf, i1 - i0, B, lane);
      for (int i = i0 + lane; i < i1; i += kWarp) {
        const float* ti = buf + (i - i0) * (B + 1);
        float q = 0.f;
        for (int j = 0; j < B; ++j) q += ti[j] * xc[j];
        s[i] = s[i] + q;
      }
    }
  }
  __syncwarp();
  for (int j = lane; j < B; j += kWarp) a.acc[(static_cast<size_t>(row) * B + j) * R + c] = s[j];
}

// x[row, :, c] = solve(diag[row], b[row, :, c] - s), s holding the pulled sum.
__device__ void solve(const Args& a, int row, int c, float* buf, float* s, int lane) {
  const int B = a.B, R = a.R, chunk = chunk_rows(B);
  for (int j = lane; j < B; j += kWarp)
    s[j] = __ldg(a.b + (static_cast<size_t>(row) * B + j) * R + c) - s[j];
  const float* L = a.diag + static_cast<size_t>(row) * B * B;
  for (int i0 = 0; i0 < B; i0 += chunk) {
    const int i1 = i0 + chunk < B ? i0 + chunk : B;
    __syncwarp();
    stage(L + static_cast<size_t>(i0) * B, buf, i1 - i0, B, lane);
    sweep_rows(buf, B + 1, i0, i1, s, lane);
  }
  for (int j = lane; j < B; j += kWarp) a.x[(static_cast<size_t>(row) * B + j) * R + c] = s[j];
}

__global__ void __launch_bounds__(kThreads) superstep_kernel(Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int gwarp = blockIdx.x * kWarpsPerCta + warp;
  const int n_warps = gridDim.x * kWarpsPerCta;
  const int R = a.R, row_el = a.B * a.R;
  float* buf = smem + warp * (kStage + 2 * a.B);
  float* s = buf + kStage;
  float* xc = s + a.B;

  // rows the launch does not solve keep the incoming x (and, unless they
  // are orphans, the incoming acc); solved rows are written when solved.
  // kCopy elements per thread per pass, all loads before the stores.
  constexpr int kCopy = 8;
  const size_t n_el = static_cast<size_t>(a.n_copy) * row_el;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e0 = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e0 < n_el;
       e0 += kCopy * stride) {
    size_t at[kCopy];
    float va[kCopy], vx[kCopy];
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const size_t e = e0 + u * stride;
      at[u] = e < n_el ? static_cast<size_t>(__ldg(a.copy_row + e / row_el)) * row_el + e % row_el
                       : 0;
      va[u] = e < n_el ? __ldg(a.acc_in + at[u]) : 0.f;
      vx[u] = e < n_el ? __ldg(a.x_in + at[u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      if (e0 + u * stride < n_el) {
        a.acc[at[u]] = va[u];
        a.x[at[u]] = vx[u];
      }
    }
  }
  grid.sync();

  for (int t = a.t_lo; t < a.t_hi; ++t) {
    const int o = __ldg(a.off + 3 * t), w = __ldg(a.wid + 3 * t);
    if (w == 0) continue;  // nothing written at this level: no barrier needed
    for (int item = gwarp; item < w * R; item += n_warps) {
      const int k = o + item / R, c = item % R;
      const int row = __ldg(a.sr + k);
      if (row < 0) continue;  // pad slot
      pull(a, k, row, c, buf, s, xc, lane);
      solve(a, row, c, buf, s, lane);
    }
    grid.sync();
  }

  for (int item = gwarp; item < a.n_orphans * R; item += n_warps) {
    const int q = item / R;
    pull(a, a.S + q, __ldg(a.orphan_row + q), item % R, buf, s, xc, lane);
  }
}

// Opts the kernel in to `bytes` of dynamic shared memory. A refusal is
// returned and cleared, so the next launch does not report it.
cudaError_t allow_shared(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      superstep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// CTAs of this kernel that can be resident at once on the current device;
// an error if the device has no cooperative launch.
cudaError_t resident_ctas(int B, int* out) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_shared(shared_bytes(B));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, superstep_kernel, kThreads,
                                                        shared_bytes(B));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  *out = per_sm * sms;
  return cudaSuccess;
}

int launch(const int* off, const int* wid, const int* sr, const int* pull_ptr,
           const int* pull_tile, const int* pull_col, const int* orphan_row, const int* copy_row,
           const float* diag, const float* tiles, const float* b, const float* acc_in,
           const float* x_in, float* acc, float* x, int t_lo, int t_hi, int B, int R, int S,
           int n_orphans, int n_copy, int max_items, int grid, void* stream) {
  if (B < 1 || B >= kStage) return cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t err = resident_ctas(B, &resident);
  if (err != cudaSuccess) return err;
  if (grid <= 0) {  // enough warps for the widest level, no more than fit at once
    const int need = (max_items * R + kWarpsPerCta - 1) / kWarpsPerCta;
    grid = need < 1 ? 1 : (need < resident ? need : resident);
  }
  Args a{off,   wid,    sr,   pull_ptr, pull_tile, pull_col, orphan_row, copy_row,
         diag,  tiles,  b,    acc_in,   x_in,      acc,      x,          t_lo,
         t_hi,  B,      R,    S,        n_orphans, n_copy};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(superstep_kernel),
                                    dim3(grid), dim3(kThreads), params, shared_bytes(B),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the refusal, or the next launch would report it
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the launch's CUDA error
// (0 on success); it never synchronises. grid <= 0 sizes the grid itself.
int repro_superstep_f32(const int* off, const int* wid, const int* sr, const int* pull_ptr,
                        const int* pull_tile, const int* pull_col, const int* orphan_row,
                        const int* copy_row, const float* diag, const float* tiles,
                        const float* b, const float* acc_in, const float* x_in, float* acc,
                        float* x, int t_lo, int t_hi, int B, int S, int n_orphans, int n_copy,
                        int max_items, int grid, void* stream) {
  return launch(off, wid, sr, pull_ptr, pull_tile, pull_col, orphan_row, copy_row, diag, tiles, b,
                acc_in, x_in, acc, x, t_lo, t_hi, B, 1, S, n_orphans, n_copy, max_items, grid,
                stream);
}

int repro_superstep_panel_f32(const int* off, const int* wid, const int* sr,
                              const int* pull_ptr, const int* pull_tile, const int* pull_col,
                              const int* orphan_row, const int* copy_row, const float* diag,
                              const float* tiles, const float* b, const float* acc_in,
                              const float* x_in, float* acc, float* x, int t_lo, int t_hi,
                              int B, int R, int S, int n_orphans, int n_copy, int max_items,
                              int grid, void* stream) {
  return launch(off, wid, sr, pull_ptr, pull_tile, pull_col, orphan_row, copy_row, diag, tiles, b,
                acc_in, x_in, acc, x, t_lo, t_hi, B, R, S, n_orphans, n_copy, max_items, grid,
                stream);
}

// Weak: every source defines it, so the sources also link into one module.
__attribute__((weak)) const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
