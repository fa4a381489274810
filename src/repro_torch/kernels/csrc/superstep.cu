// The superstep megakernel for Hopper, resident and streamed: a whole
// single-device solve in one cooperative launch.
//
// Replaces src/repro/kernels/superstep.py::_superstep_kernel in its resident
// form (superstep_call(stream=False), split_delta=False) and in its
// streamed form (stream=True, _step_copies), as two instantiations of one
// kernel (superstep_kernel<kStream>) that share every arithmetic step. For each level of
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
// The streamed form. The reference streams each superstep's schedule-
// ordered slice of diag and tiles into VMEM while the previous one
// computes. Its store groups tiles by the level that sources them; a pulling
// kernel uses them by the row that receives them, so the port streams its
// own store (kernels/superstep.py::streamed_layout): for each solve slot its
// incoming tiles in pull order, then its diagonal tile, slot after slot, so
// a level is one contiguous run and a work item one contiguous range. Each
// tile's rows are padded to B + 1 floats (no bank conflicts for a lane per
// row) and the tile to a multiple of four floats, so every entry is 16-byte
// aligned and every bulk copy a multiple of 16 bytes, odd B included. A
// warp double-buffers its own sequence of work items in shared memory: TMA
// bulk copies (cp.async.bulk ... mbarrier::complete_tx) into two stages, each
// completing an mbarrier; the warp's next item (at the next level, most
// often) is issued before it computes the current one, so before the grid
// barrier that ends the level. Tile values do not depend on x, so that is
// legal; x itself is still read with __ldcg after the barrier. An item
// wider than a stage (more incoming tiles than fit) arrives in chunks, each
// issued one chunk ahead. Before a stage is refilled, the warp's reads of it
// are ordered before the async proxy's writes by fence.proxy.async. A panel
// column is a work item of its own, so each column's warp copies its slot's
// tiles (R times the bytes of a vector solve, counted in stream_dma_bytes).
// kernels/superstep.py::streamed_shape picks warps per CTA and tiles per
// stage so the CTA fits 227 KB of shared memory.
//
// Layout: b, acc, x (n_rows, B, R) row-major float32 (R = 1 for vectors),
// diag (n_rows, B, B), tiles (ML+1, B, B); the streamed store (entries,
// round_up(B (B + 1), 4)); int32 tables. The wrappers (kernels/superstep.py)
// check shapes, dtype, device and contiguity.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rowsweep.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::kWarp;
using repro::sweep_rows;

constexpr int kWarpsPerCta = 8;  // the resident kernel's; the streamed one takes 1 to 8
constexpr int kMaxThreads = kWarpsPerCta * kWarp;
constexpr int kStage = 33 * kWarp;  // staging floats per warp: a B = 32 tile, rows padded
constexpr size_t kSharedLimit = 232448;  // dynamic shared memory a Hopper block may use

struct Args {
  const int* off;         // (T, 3) level offsets into the flats
  const int* wid;         // (T, 3) level widths
  const int* sr;          // (S,) solve rows, pad -1
  const int* pull_ptr;    // (S + n_orphans + 1,) incoming-tile ranges per target
  const int* pull_tile;   // incoming tile ids, in the reference's order (resident)
  const int* pull_col;    // the source block row (tcol) of each incoming tile
  const int* orphan_row;  // (n_orphans,) rows updated but not solved
  const int* copy_row;    // (n_copy,) rows not solved: they keep the incoming x
  const float* diag;      // resident stores
  const float* tiles;
  const float* store;     // the streamed store (entries of `stride` floats)
  const float* b;
  const float* acc_in;
  const float* x_in;
  float* acc;
  float* x;
  int t_lo, t_hi;  // level range of the launch
  int B, R, S, n_orphans, n_copy;
  int cap, stride;  // streamed: tiles per stage, floats per store entry
};

// Resident: per warp, a staging buffer of kStage floats, the row's sum (B)
// and the tile's source column (B).
size_t shared_bytes(int B) { return sizeof(float) * kWarpsPerCta * (kStage + 2 * B); }

// Streamed: per warp, two 8-byte mbarriers, two stages of `cap` store
// entries, the row's sum and the source column; laid out in that order
// (kernels/superstep.py::_streamed_bytes is the same formula).
size_t streamed_bytes(int warps, int cap, int B, int stride) {
  return static_cast<size_t>(warps) * (16 + 2 * static_cast<size_t>(cap) * 4 * stride + 8 * B);
}

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

// s[i] += (row i of a tile) . xc for rows i in [i0, i1), one lane per row,
// a float32 FMA chain over the row in column order. T points at row i0 in
// shared memory, rows ld floats apart. Both forms of the kernel compute
// every tile product here.
__device__ __forceinline__ void tile_rows(const float* T, int ld, int i0, int i1,
                                          const float* xc, float* s, int B, int lane) {
  for (int i = i0 + lane; i < i1; i += kWarp) {
    const float* ti = T + (i - i0) * ld;
    float q = 0.f;
    for (int j = 0; j < B; ++j) q += ti[j] * xc[j];
    s[i] = s[i] + q;
  }
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
      tile_rows(buf, B + 1, i0, i1, xc, s, B, lane);
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

// ---------------------------------------------------------------------------
// The streamed form: each warp's work items, in the order the warp runs
// them, arrive in shared memory by TMA bulk copies, one chunk ahead.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
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

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on the mbarrier `bar`,
// which is told to expect that many bytes. One thread issues it.
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Moves (t, item) to this warp's next live work item at or after it, in
// the order the kernel runs them (levels, then the orphans once t == t_hi),
// and sets [e0, e1) to the item's store entries; false past the last item.
// Target k < S (a solve slot) holds entries [pull_ptr[k] + k,
// pull_ptr[k+1] + k + 1): its incoming tiles, then its diagonal tile;
// orphan q, target S + q, only incoming tiles.
__device__ bool seek(const Args& a, int gwarp, int n_warps, int& t, int& item, int& e0,
                     int& e1) {
  for (;;) {
    if (t < a.t_hi) {
      if (item < __ldg(a.wid + 3 * t) * a.R) {
        const int k = __ldg(a.off + 3 * t) + item / a.R;
        if (__ldg(a.sr + k) >= 0) {
          e0 = __ldg(a.pull_ptr + k) + k;
          e1 = __ldg(a.pull_ptr + k + 1) + k + 1;
          return true;
        }
        item += n_warps;  // pad slot: no work, nothing copied
      } else {
        ++t;
        item = gwarp;
      }
    } else {
      if (item >= a.n_orphans * a.R) return false;
      const int q = a.S + item / a.R;
      e0 = __ldg(a.pull_ptr + q) + a.S;
      e1 = __ldg(a.pull_ptr + q + 1) + a.S;
      return true;
    }
  }
}

// A warp's double buffer. Its items' entries, cut into chunks of at most
// `cap`, form one sequence; chunk j lands in stage j % 2 and completes that
// stage's mbarrier for the (j / 2)-th time. While chunk j is computed,
// chunk j + 1 is in flight: the copy of a warp's next item (at the next
// level, most often) is issued before the grid barrier that ends the level
// it computes. Tile values do not depend on x, so that is legal.
struct Stream {
  float* stage[2];
  uint32_t bar[2];
  int t, item, e, e_end;  // the item being issued and its entries still to issue
  unsigned issued, used;  // chunks issued; chunks computed
};

__device__ void issue_next(const Args& a, Stream& st, int gwarp, int n_warps, int lane) {
  if (st.e >= st.e_end) return;  // the warp's last chunk is already in flight
  const int n = min(a.cap, st.e_end - st.e);
  const int sl = st.issued & 1;
  if (lane == 0)
    bulk_load(smem_addr(st.stage[sl]), a.store + static_cast<size_t>(st.e) * a.stride,
              static_cast<uint32_t>(n) * a.stride * 4, st.bar[sl]);
  ++st.issued;
  st.e += n;
  if (st.e == st.e_end) {
    st.item += n_warps;
    if (!seek(a, gwarp, n_warps, st.t, st.item, st.e, st.e_end)) st.e = st.e_end = 0;
  }
}

__device__ void stream_init(const Args& a, Stream& st, uint64_t* bars, float* stages,
                            int gwarp, int n_warps, int lane) {
  st.stage[0] = stages;
  st.stage[1] = stages + static_cast<size_t>(a.cap) * a.stride;
  st.bar[0] = smem_addr(bars);
  st.bar[1] = smem_addr(bars + 1);
  if (lane == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(st.bar[i]) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  st.issued = st.used = 0;
  st.t = a.t_lo;
  st.item = gwarp;
  if (!seek(a, gwarp, n_warps, st.t, st.item, st.e, st.e_end)) st.e = st.e_end = 0;
  issue_next(a, st, gwarp, n_warps, lane);  // the warp's first chunk
}

// The next chunk in the warp's sequence, once it has landed; first issues
// the chunk after it into the other stage, which the previous chunk freed.
__device__ const float* acquire(const Args& a, Stream& st, int gwarp, int n_warps, int lane) {
  issue_next(a, st, gwarp, n_warps, lane);
  const int sl = st.used & 1;
  mbar_wait(st.bar[sl], (st.used >> 1) & 1);
  return st.stage[sl];
}

// The warp is done reading the chunk: order its reads (generic proxy)
// before the bulk copy (async proxy) that will refill the stage.
__device__ void release(Stream& st) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  ++st.used;
}

// One streamed work item: pull() for `target`, then, for a solve slot,
// solve(), on the tiles of its entries as they arrive. The arithmetic is
// the resident form's, operation for operation: the same tile_rows() and
// sweep_rows() on the same values in the same order, so both forms give
// the same bits.
__device__ void streamed_item(const Args& a, Stream& st, int gwarp, int n_warps, int target,
                              int row, int c, bool slot, float* s, float* xc, int lane) {
  const int B = a.B, R = a.R;
  for (int j = lane; j < B; j += kWarp)
    s[j] = __ldg(a.acc_in + (static_cast<size_t>(row) * B + j) * R + c);
  const int p0 = __ldg(a.pull_ptr + target);
  const int n_pull = __ldg(a.pull_ptr + target + 1) - p0;
  const int n_ent = n_pull + (slot ? 1 : 0);
  for (int e = 0; e < n_ent;) {
    const float* buf = acquire(a, st, gwarp, n_warps, lane);
    const int n = min(a.cap, n_ent - e);
    for (int u = 0; u < n; ++u, ++e) {
      const float* T = buf + static_cast<size_t>(u) * a.stride;  // rows B + 1 floats apart
      if (e < n_pull) {
        const float* xv = a.x + static_cast<size_t>(__ldg(a.pull_col + p0 + e)) * B * R + c;
        __syncwarp();  // the previous tile's reads of xc and s are done
        for (int j = lane; j < B; j += kWarp) xc[j] = __ldcg(xv + static_cast<size_t>(j) * R);
        __syncwarp();
        tile_rows(T, B + 1, 0, B, xc, s, B, lane);
      } else {  // the diagonal tile: store the pulled sum, then solve
        __syncwarp();
        for (int j = lane; j < B; j += kWarp) {
          const size_t at = (static_cast<size_t>(row) * B + j) * R + c;
          a.acc[at] = s[j];
          s[j] = __ldg(a.b + at) - s[j];
        }
        __syncwarp();
        sweep_rows(T, B + 1, 0, B, s, lane);
        for (int j = lane; j < B; j += kWarp)
          a.x[(static_cast<size_t>(row) * B + j) * R + c] = s[j];
      }
    }
    release(st);
  }
  if (!slot) {  // an orphan: only the pulled sum
    __syncwarp();
    for (int j = lane; j < B; j += kWarp)
      a.acc[(static_cast<size_t>(row) * B + j) * R + c] = s[j];
  }
}

template <bool kStream>
__global__ void __launch_bounds__(kMaxThreads) superstep_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int gwarp = blockIdx.x * warps + warp;
  const int n_warps = gridDim.x * warps;
  const int R = a.R, row_el = a.B * a.R;
  float* buf = nullptr;
  float* s;
  Stream st;
  if constexpr (kStream) {
    float* stages = reinterpret_cast<float*>(smem + 16 * warps);
    s = stages + static_cast<size_t>(warps) * 2 * a.cap * a.stride + warp * 2 * a.B;
    stream_init(a, st, reinterpret_cast<uint64_t*>(smem) + 2 * warp,
                stages + static_cast<size_t>(warp) * 2 * a.cap * a.stride, gwarp, n_warps,
                lane);
  } else {
    buf = reinterpret_cast<float*>(smem) + warp * (kStage + 2 * a.B);
    s = buf + kStage;
  }
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
      if constexpr (kStream) {
        streamed_item(a, st, gwarp, n_warps, k, row, c, true, s, xc, lane);
      } else {
        pull(a, k, row, c, buf, s, xc, lane);
        solve(a, row, c, buf, s, lane);
      }
    }
    grid.sync();
  }

  for (int item = gwarp; item < a.n_orphans * R; item += n_warps) {
    const int q = item / R, row = __ldg(a.orphan_row + q);
    if constexpr (kStream)
      streamed_item(a, st, gwarp, n_warps, a.S + q, row, item % R, false, s, xc, lane);
    else
      pull(a, a.S + q, row, item % R, buf, s, xc, lane);
  }
}

// Opts the kernel in to `bytes` of dynamic shared memory. A refusal is
// returned and cleared, so the next launch does not report it.
template <bool kStream>
cudaError_t allow_shared(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      superstep_kernel<kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// CTAs of this kernel that can be resident at once on the current device;
// an error if the device has no cooperative launch.
template <bool kStream>
cudaError_t resident_ctas(int threads, size_t smem, int* out) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_shared<kStream>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, superstep_kernel<kStream>,
                                                        threads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  *out = per_sm * sms;
  return cudaSuccess;
}

template <bool kStream>
int launch(Args a, int warps, int max_items, int grid, void* stream) {
  const size_t smem = kStream ? streamed_bytes(warps, a.cap, a.B, a.stride) : shared_bytes(a.B);
  int resident = 0;
  cudaError_t err = resident_ctas<kStream>(warps * kWarp, smem, &resident);
  if (err != cudaSuccess) return err;
  if (grid <= 0) {  // enough warps for the widest level, no more than fit at once
    const int need = (max_items * a.R + warps - 1) / warps;
    grid = need < 1 ? 1 : (need < resident ? need : resident);
  }
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(superstep_kernel<kStream>),
                                    dim3(grid), dim3(warps * kWarp), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the refusal, or the next launch would report it
    return err;
  }
  return cudaGetLastError();
}

int launch_resident(const int* off, const int* wid, const int* sr, const int* pull_ptr,
                    const int* pull_tile, const int* pull_col, const int* orphan_row,
                    const int* copy_row, const float* diag, const float* tiles, const float* b,
                    const float* acc_in, const float* x_in, float* acc, float* x, int t_lo,
                    int t_hi, int B, int R, int S, int n_orphans, int n_copy, int max_items,
                    int grid, void* stream) {
  if (B < 1 || B >= kStage) return cudaErrorInvalidValue;
  Args a{off,    wid,    sr,   pull_ptr, pull_tile, pull_col, orphan_row, copy_row,
         diag,   tiles,  nullptr, b,     acc_in,    x_in,     acc,        x,
         t_lo,   t_hi,   B,    R,        S,         n_orphans, n_copy,    0,
         0};
  return launch<false>(a, kWarpsPerCta, max_items, grid, stream);
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
  return launch_resident(off, wid, sr, pull_ptr, pull_tile, pull_col, orphan_row, copy_row, diag,
                         tiles, b, acc_in, x_in, acc, x, t_lo, t_hi, B, 1, S, n_orphans, n_copy,
                         max_items, grid, stream);
}

int repro_superstep_panel_f32(const int* off, const int* wid, const int* sr,
                              const int* pull_ptr, const int* pull_tile, const int* pull_col,
                              const int* orphan_row, const int* copy_row, const float* diag,
                              const float* tiles, const float* b, const float* acc_in,
                              const float* x_in, float* acc, float* x, int t_lo, int t_hi,
                              int B, int R, int S, int n_orphans, int n_copy, int max_items,
                              int grid, void* stream) {
  return launch_resident(off, wid, sr, pull_ptr, pull_tile, pull_col, orphan_row, copy_row, diag,
                         tiles, b, acc_in, x_in, acc, x, t_lo, t_hi, B, R, S, n_orphans, n_copy,
                         max_items, grid, stream);
}

// The streamed form: `store` is the streamed store (kernels/superstep.py::
// streamed_values), entries of round_up(B (B + 1), 4) floats; `warps` per
// CTA and `cap` entries per stage come from kernels/superstep.py::
// streamed_shape. Vectors and (n, R) panels alike.
int repro_superstep_streamed_f32(const int* off, const int* wid, const int* sr,
                                 const int* pull_ptr, const int* pull_col,
                                 const int* orphan_row, const int* copy_row, const float* store,
                                 const float* b, const float* acc_in, const float* x_in,
                                 float* acc, float* x, int t_lo, int t_hi, int B, int R, int S,
                                 int n_orphans, int n_copy, int max_items, int grid, int warps,
                                 int cap, void* stream) {
  const int stride = (B * (B + 1) + 3) / 4 * 4;
  if (B < 1 || R < 1 || warps < 1 || warps > kWarpsPerCta || cap < 1 ||
      streamed_bytes(warps, cap, B, stride) > kSharedLimit)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(store) % 16 != 0) return cudaErrorMisalignedAddress;
  Args a{off,   wid,   sr,    pull_ptr, nullptr, pull_col, orphan_row, copy_row,
         nullptr, nullptr, store, b,     acc_in,  x_in,     acc,        x,
         t_lo,  t_hi,  B,     R,        S,       n_orphans, n_copy,    cap,
         stride};
  return launch<true>(a, warps, max_items, grid, stream);
}

// Weak: every source defines it, so the sources also link into one module.
__attribute__((weak)) const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
