// The superstep megakernel for Hopper, resident and streamed: a whole
// single-device solve in one cooperative launch, or one superstep of a
// multi-device solve with comm="unified".
//
// Replaces src/repro/kernels/superstep.py::_superstep_kernel in its resident
// form (superstep_call(stream=False)) and in its streamed form (stream=True,
// _step_copies), each with split_delta=False and split_delta=True, as four
// instantiations of one kernel (superstep_kernel<kStream, kSplit>) that share
// every arithmetic step. For each level of the launch's superstep range, in
// order, the reference solves the level's rows with rhs = b - acc, then
// applies the level's tile updates acc[trow] += tile @ x[tcol]. The split
// form (kSplit; the unified executor's, core/solver.py) moves the
// accumulator's role to a third carry: tile updates land in delta, solves
// read rhs = (b - acc) - delta in that order, and acc (the sum of every
// device's earlier supersteps, all-reduced between launches) is only read.
// It is correct on the TPU because the grid
// programs run one after another on one core; CUDA blocks do not, so the
// port is one persistent, cooperative kernel:
//
// * Co-residency: the kernel is launched with cudaLaunchCooperativeKernel,
//   which refuses a grid that cannot be resident all at once. The entry
//   point returns that refusal (or a device without cooperative launch)
//   as an error; it never spins over a grid that might not be resident.
// * Pull, not push: the host builds, once per plan, each solved row's list
//   of incoming tiles in the order the reference adds them (level, then
//   position in the flat update schedule; kernels/superstep.py::
//   superstep_table). The warp that solves row r sums them into acc[r]
//   (delta[r] in the split form), starting from the incoming carry, right
//   before it solves. No
//   floating-point atomics: a real-valued solve gives the same bits run
//   after run. Rows that receive updates but are not solved in the launch
//   ("orphans") are summed after the last level. Updates into the pad row
//   (the zero pad tile) are not applied.
// * Per-row ready flags, not a barrier per level. Work items are (solve
//   slot, right-hand-side column) pairs, one warp each, and each warp runs
//   its items in level order. The warp that solves row r, column c writes
//   x, passes a warp barrier, and lane 0 publishes flags[r R + c] = epoch
//   with a release store at GPU scope (the epoch is a launch counter the
//   wrapper passes in, so the flags are never cleared between launches).
//   For the rows an item pulls from, lane g polls source g's flag with an
//   acquire load until it holds the epoch (kGather sources at once, so an
//   item's waits overlap), then the warp reads their x with __ldcg (L2,
//   never a stale L1 line), all loads before the first use. A row waits
//   for the rows it pulls from, not for the whole level. Every dependency
//   points to an earlier level and the grid is co-resident, so the warp
//   holding the lowest unfinished item can always proceed. A pull from a
//   row the launch does not solve (a copy row: x comes from x_in, copied
//   before the launch's one grid barrier) is marked by the host
//   (pull_wait = 0) and never waits.
// * Off the chain: b[row] and acc_in[row] do not depend on x; a warp loads
//   them into registers when it starts an item, before any wait. Tiles do
//   not depend on x either: each warp prefetches its next pieces of work
//   into shared memory before it waits (below). The level walk loads each
//   level's offset and width one level ahead.
//
// The diagonal solve is a column sweep held in registers: lane l owns row
// i0 + l of a block of at most 32 rows and keeps its right-hand side in a
// register. It first subtracts the columns solved before the block; then,
// for each column j of the block, every lane divides its value by its own
// diagonal entry (an IEEE division), one __shfl_sync hands lane j's quotient
// x_j to all, and every lane below j does r = fmaf(-L_ij, x_j, r). The chain
// per column is one division, one shuffle and one FMA. Row i's value is
// b_i - acc_i, then fmaf by L_i0 x_0, ..., L_i,i-1 x_{i-1} in column order,
// then the division, however the rows are cut into blocks, so both forms
// (and any chunking) give the same bits. L is read from padded rows (B + 1
// floats apart): a column read, one lane per row, has no bank conflict, and
// the reads do not depend on x. Tile products are float32 FMAs (no TF32,
// no tensor cores), one lane per tile row, summed over the row in column
// order (tile_rows). This order is not the reference's row sweep; on the
// dyadic problems every intermediate is exact, so the bits agree, and on
// real values the solve agrees to float32 rounding.
//
// The resident form reads diag and tiles where they lie. Each warp keeps a
// ring of kRing stages of kStage floats in shared memory and walks its work
// items, in the order it runs them, as a sequence of pieces: for each item
// its incoming tiles in pull order, then its diagonal tile, each cut into
// row chunks that fit a stage (a whole tile for B <= 32). Each piece is a
// cp.async gather, a lane per column (4-byte copies: a row of B + 1 floats
// is only 4-byte aligned), into padded rows, issued kRing - 1 pieces ahead,
// so the pieces of a warp's next item are in flight while it waits for the
// current one's sources; each piece's tile id is loaded one piece ahead.
// One commit group per piece (empty past the last) keeps
// cp.async.wait_group's count exact.
//
// The streamed form. The reference streams each superstep's schedule-
// ordered slice of diag and tiles into VMEM while the previous one
// computes. Its store groups tiles by the level that sources them; a pulling
// kernel uses them by the row that receives them, so the port streams its
// own store (kernels/superstep.py::streamed_layout): for each solve slot its
// incoming tiles in pull order, then its diagonal tile, slot after slot, so
// a level is one contiguous run and a work item one contiguous range. Each
// tile's rows are padded to B + 1 floats and the tile to a multiple of four
// floats, so every entry is 16-byte aligned and every bulk copy a multiple
// of 16 bytes, odd B included. A warp double-buffers its own sequence of
// work items in shared memory: TMA bulk copies (cp.async.bulk ...
// mbarrier::complete_tx) into two stages, each completing an mbarrier; the
// warp's next item is issued before it computes the current one. An item
// wider than a stage arrives in chunks, each issued one chunk ahead. Before
// a stage is refilled, the warp's reads of it are ordered before the async
// proxy's writes by fence.proxy.async. A panel column is a work item of its
// own, so each column's warp copies its slot's tiles (R times the bytes of
// a vector solve, counted in stream_dma_bytes).
// kernels/superstep.py::streamed_shape picks warps per CTA and tiles per
// stage so the CTA fits 227 KB of shared memory.
//
// Row chunks (B >= 170), where two stages of one whole tile do not fit.
// One CTA of W = min(8, ceil(B / 32)) warps runs each work item (cta_item),
// and its warps share one ring of kChunkStages stages of `rows` padded tile
// rows: as few chunks a tile as fit, evened out, `rows` a multiple of four
// (so a chunk's offset i0 (B + 1) 4 bytes is a multiple of 16 for odd and
// even B; a tile's last chunk runs to the entry's padded end, a multiple of
// 16 bytes too; rows <= 32 W). A level's items are dealt round the grid in
// slot order (cta_first), so consecutive levels go to different CTAs: each
// CTA, its items in level order (so the co-residency argument above holds
// per CTA), copies and multiplies what its next item pulls from earlier
// levels while the levels before it finish. An item's chunks are,
// for each incoming tile, its rows in chunks, then the diagonal tile's;
// one producer thread walks the items and issues each chunk's bulk copy
// kChunkStages - 1 chunks ahead, every thread waits on the stage's
// mbarrier, and a stage is refilled only after a CTA barrier shows every
// warp is done with it (then the producer's fence.proxy.async). Warp 0
// waits for the sources and reads them, as a warp does above, before a
// CTA barrier; the last pull, the newest source, is a group of its own, so
// the pulls before it need not wait for it. Tile products: thread t
// computes chunk row i0 + t, the same FMA chain over the row in column
// order as tile_rows, so an 88-row chunk is one pass of 88 threads. The
// sweep (cta_sweep): warp k owns the chunk's 32-row block k; every warp
// first subtracts the columns of earlier chunks from its rows, all at once,
// then the blocks run as a wavefront: warp k waits on named barrier 1 + m
// for each earlier block m and applies its 32 columns, then sweeps its own
// block as column_sweep does and publishes it with bar.arrive. Row i still
// takes columns 0 .. i - 1 in order, then its division, so the bits are
// the resident form's at every B. x is stored by every thread, then a CTA
// barrier, then one thread's release of the flag, which is cumulative over
// the stores the barrier ordered before it.
//
// Bound: the bytes of the stores (each solved row's lower triangle and each
// pulled tile read once) over the memory rate, about 0.1 ms for the 1M-row
// factor. The kernel is far from it: a solve is a chain of dependent levels,
// and each level's time is its latency chain: the flag round trip through
// L2, the source column's read, the tile FMAs and the B-column sweep
// (PERF.md). In row chunks the floor is the sweep's chain, B dependent
// divisions and FMAs a level: 6.0 ms for the 1444 levels of
// grid2d_factor(512) at B = 176, 3.1 ms for its 513 at B = 256, against a
// bytes bound of 0.19 / 0.16 ms. This form takes 24.1 / 16.5 ms there (one
// warp an item took 74.8 / 40.9): the division alone is ~30 ns a column of
// it, and one CTA's bulk copies move ~72 bytes a ns (perf/chain_variants.py,
// perf/bulk_copy.py; PERF.md).
//
// Layout: b, acc, x (n_rows, B, R) row-major float32 (R = 1 for vectors),
// diag (n_rows, B, B), tiles (ML+1, B, B); the streamed store (entries,
// round_up(B (B + 1), 4)); flags (n_rows R) int32; int32 tables. The
// wrappers (kernels/superstep.py) check shapes, dtype, device and
// contiguity.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerCta = 8;  // the resident kernel's; the streamed one takes 1 to 8
constexpr int kMaxThreads = kWarpsPerCta * kWarp;
constexpr int kStage = 33 * kWarp;  // floats of a resident stage: a B = 32 tile, rows padded
constexpr int kRing = 3;            // resident stages per warp
constexpr int kGather = 2;          // source columns a warp waits for and reads at once
constexpr size_t kSharedLimit = 232448;  // dynamic shared memory a Hopper block may use
// The row-chunked streamed form's ring (kernels/superstep.py::CHUNK_STAGES)
// and the bytes of its mbarriers, rounded up so the stages are 16-byte
// aligned.
constexpr int kChunkStages = 2;
constexpr int kChunkBarBytes = (8 * kChunkStages + 15) / 16 * 16;
// Polls of one flag before the wait is taken for lost (a schedule that
// cannot finish): the kernel traps, and the launch fails, instead of
// spinning for ever. Each poll is an L2 round trip, so this is many seconds.
constexpr long long kSpinLimit = 1ll << 26;

struct Args {
  const int* off;         // (T, 3) level offsets into the flats
  const int* wid;         // (T, 3) level widths
  const int* sr;          // (S,) solve rows, pad -1
  const int* pull_ptr;    // (S + n_orphans + 1,) incoming-tile ranges per target
  const int* pull_tile;   // incoming tile ids, in the reference's order (resident)
  const int* pull_col;    // the source block row (tcol) of each incoming tile
  const int* pull_wait;   // 1 where the source row is solved in this launch
  const int* orphan_row;  // (n_orphans,) rows updated but not solved
  const int* copy_row;    // (n_copy,) rows not solved: they keep the incoming x
  const float* diag;      // resident stores
  const float* tiles;
  const float* store;     // the streamed store (entries of `stride` floats)
  const float* b;
  const float* acc_in;
  const float* x_in;
  float* acc;             // unsplit: written; split: null (acc_in is read only)
  float* delta;           // split: the carry the pulls sum into, in place
  float* x;
  int* flags;             // (n_rows R,) per-row ready flags
  int t_lo, t_hi;  // level range of the launch
  int B, R, S, n_orphans, n_copy;
  int cap, stride;  // streamed: tiles per stage, floats per store entry
  int rows;         // streamed: tile rows per stage (B: whole tiles; < B: row chunks)
  int chunk;        // resident: tile rows per stage
  int epoch;        // this launch's flag value, never 0
};

// Resident: per warp, kRing stages of kStage floats, then 1 + kGather
// columns of B floats: the row's sum and the source columns.
size_t shared_bytes(int B) {
  return sizeof(float) * kWarpsPerCta * (kRing * kStage + (1 + kGather) * B);
}

// Floats of one streamed stage: `cap` store entries, or `rows` padded tile
// rows where a stage holds less than a tile (kernels/superstep.py::
// stage_floats).
__host__ __device__ __forceinline__ size_t stage_floats(int cap, int rows, int B, int stride) {
  return rows < B ? static_cast<size_t>(rows) * (B + 1) : static_cast<size_t>(cap) * stride;
}

// Streamed: per warp, two 8-byte mbarriers, two stages, the same columns;
// in row chunks, once for the CTA, whose warps share them, with
// kChunkStages stages. Laid out in that order (kernels/superstep.py::
// _streamed_bytes is the same formula).
size_t streamed_bytes(int warps, int cap, int rows, int B, int stride) {
  const size_t columns = 4 * (1 + kGather) * B, stage = 4 * stage_floats(cap, rows, B, stride);
  if (rows < B) return kChunkBarBytes + kChunkStages * stage + columns;
  return static_cast<size_t>(warps) * (16 + 2 * stage + columns);
}

// Warps of the CTA that runs each work item in row chunks: one per 32 rows
// of the tile, at most kWarpsPerCta (kernels/superstep.py::streamed_shape).
int chunk_warps(int B) {
  return (B + kWarp - 1) / kWarp < kWarpsPerCta ? (B + kWarp - 1) / kWarp : kWarpsPerCta;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Rows [i0, i1) (at most 32) of a forward substitution, column by column in
// registers. s holds the right-hand side of rows i >= i0 and the solution
// of rows i < i0 on entry, the solution of rows < i1 on exit. T points at
// row i0 of a lower-triangular tile in shared memory, rows ld floats apart.
// Lane l owns row i0 + l; see the note at the top for the order of the
// operations, which is what both forms share.
__device__ __forceinline__ void column_sweep(const float* T, int ld, int i0, int i1, float* s,
                                             int lane) {
  const int n = i1 - i0;
  const bool own = lane < n;
  const float* ti = T + (own ? lane : 0) * ld;
  float r = own ? s[i0 + lane] : 0.f;
  const float lii = own ? ti[i0 + lane] : 1.f;
  for (int j = 0; j < i0; ++j) r = fmaf(-ti[j], s[j], r);
#pragma unroll 4
  for (int o = 0; o < n; ++o) {
    const float xj = __shfl_sync(0xffffffffu, __fdiv_rn(r, lii), o);
    if (lane > o) r = fmaf(-ti[i0 + o], xj, r);
    if (lane == o) s[i0 + o] = xj;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// Ready flags and the item's inputs
// ---------------------------------------------------------------------------

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

// Source columns of pulls [p, p + n), n <= kGather, into xcs (column g at
// xcs + g B). Lane g < n waits until source row g's flag for column c
// holds the launch's epoch, unless the host marked the pull as reading a
// row this launch does not solve, so the item's waits overlap; then the
// warp reads the n columns with __ldcg, every load before the first store.
// The pull order of the sums is untouched: the columns are used in order.
__device__ void gather_sources(const Args& a, int p, int n, int c, float* xcs, int lane) {
  const int src = lane < n ? __ldg(a.pull_col + p + lane) : 0;
  if (lane < n && __ldg(a.pull_wait + p + lane)) {
    const int* f = a.flags + static_cast<size_t>(src) * a.R + c;
    for (long long k = 0; load_acquire(f) != a.epoch;)
      if (++k == kSpinLimit) __trap();
  }
  __syncwarp();  // the sources are solved; the previous pulls' reads of xcs are done
  int sg[kGather];
#pragma unroll
  for (int g = 0; g < kGather; ++g) sg[g] = __shfl_sync(0xffffffffu, src, g);
  for (int j = lane; j < a.B; j += kWarp) {
    float v[kGather];
#pragma unroll
    for (int g = 0; g < kGather; ++g)
      v[g] = g < n ? __ldcg(a.x + (static_cast<size_t>(sg[g]) * a.B + j) * a.R + c) : 0.f;
#pragma unroll
    for (int g = 0; g < kGather; ++g)
      if (g < n) xcs[g * a.B + j] = v[g];
  }
  __syncwarp();
}

// The incoming carry and b of the row a lane owns in the sweep (row `lane`),
// loaded into registers when the item starts, before any wait, and used
// after it. Rows from 32 on (B > 32) take the carry into s at once and b
// when it is used. The split form's carry is delta, and its b is b - acc,
// rounded once, as the reference forms it before it subtracts delta.
struct Carry {
  float acc, b;
};

// The split form updates delta in place. Each element of delta is read by
// one warp only, the one whose item targets that row and column, once, when
// the item starts, and written by the same warp after its pulls; no element
// is read after it is written in the launch, so no warp can find a stale
// line in a cache. The reads still go through L2 (__ldcg), not the
// read-only path. acc_in, in the split form the same buffer as the caller's
// acc, is not written at all in the launch.
template <bool kSplit>
__device__ __forceinline__ float carry_in(const Args& a, size_t at) {
  if constexpr (kSplit) return __ldcg(a.delta + at);
  return __ldg(a.acc_in + at);
}

template <bool kSplit>
__device__ __forceinline__ float rhs_base(const Args& a, size_t at) {
  if constexpr (kSplit) return __ldg(a.b + at) - __ldg(a.acc_in + at);
  return __ldg(a.b + at);
}

template <bool kSplit>
__device__ __forceinline__ Carry item_inputs(const Args& a, int row, int c, bool slot,
                                             float* s, int lane) {
  Carry in{0.f, 0.f};
  for (int j = lane; j < a.B; j += kWarp) {
    const size_t at = (static_cast<size_t>(row) * a.B + j) * a.R + c;
    if (j == lane) {
      in.acc = carry_in<kSplit>(a, at);
      if (slot) in.b = rhs_base<kSplit>(a, at);
    } else {
      s[j] = carry_in<kSplit>(a, at);
    }
  }
  return in;
}

// The carry into s, for the first tile product (each lane its own row).
__device__ __forceinline__ void place(const Carry& in, float* s, int B, int lane) {
  if (lane < B) s[lane] = in.acc;
}

// After the pulls: acc = s, and, for a solve slot, s = b - acc, the
// sweep's right-hand side; in the split form delta = s and
// s = (b - acc) - delta.
template <bool kSplit>
__device__ __forceinline__ void store_sum(const Args& a, int row, int c, bool slot,
                                          const Carry& in, float* s, int lane) {
  __syncwarp();
  for (int j = lane; j < a.B; j += kWarp) {
    const size_t at = (static_cast<size_t>(row) * a.B + j) * a.R + c;
    if constexpr (kSplit)
      a.delta[at] = s[j];
    else
      a.acc[at] = s[j];
    if (slot) s[j] = (j == lane ? in.b : rhs_base<kSplit>(a, at)) - s[j];
  }
  __syncwarp();
}

// x[row, :, c] = s, then the row's flag: after the warp barrier, lane 0's
// release store orders every lane's x before the epoch it publishes.
__device__ __forceinline__ void store_x(const Args& a, int row, int c, const float* s,
                                        int lane) {
  for (int j = lane; j < a.B; j += kWarp)
    a.x[(static_cast<size_t>(row) * a.B + j) * a.R + c] = s[j];
  __syncwarp();
  if (lane == 0) store_release(a.flags + static_cast<size_t>(row) * a.R + c, a.epoch);
}

// ---------------------------------------------------------------------------
// A warp's sequence of work items, shared by both prefetchers
// ---------------------------------------------------------------------------

// Work item cursor: level t (t_hi: the orphans), the item's index there,
// and, once found, its target (slot k < S or orphan S + q), its first pull
// p0 and its entries: its incoming tiles, then, for a slot, its diagonal
// tile.
struct Cursor {
  int t, item, target, n_ent, p0;
};

// Moves c to this warp's next live work item at or after it, in the order
// the kernel runs them (levels, then the orphans once t == t_hi); false
// past the last item.
__device__ bool seek(const Args& a, int gwarp, int n_warps, Cursor& c) {
  for (;;) {
    if (c.t < a.t_hi) {
      if (c.item < __ldg(a.wid + 3 * c.t) * a.R) {
        const int k = __ldg(a.off + 3 * c.t) + c.item / a.R;
        if (__ldg(a.sr + k) >= 0) {
          c.target = k;
          c.p0 = __ldg(a.pull_ptr + k);
          c.n_ent = __ldg(a.pull_ptr + k + 1) - c.p0 + 1;
          return true;
        }
        c.item += n_warps;  // pad slot: no work, nothing copied
      } else {
        ++c.t;
        c.item = gwarp;
      }
    } else {
      if (c.item >= a.n_orphans * a.R) return false;
      c.target = a.S + c.item / a.R;
      c.p0 = __ldg(a.pull_ptr + c.target);
      c.n_ent = __ldg(a.pull_ptr + c.target + 1) - c.p0;
      return true;
    }
  }
}

// ---------------------------------------------------------------------------
// The resident form's ring: cp.async gathers from diag and tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}

struct Ring {
  float* stage;  // kRing stages of kStage floats
  Cursor cur;    // the item being issued
  int e, i0;     // its entry and row chunk still to issue
  int id;        // that entry's tile: an update tile's id, or ~row for a diagonal tile
  bool live;
  unsigned issued, used;  // pieces issued; pieces computed
};

// The tile of entry e of the cursor's item, as Ring::id encodes it.
__device__ __forceinline__ int piece_id(const Args& a, const Cursor& c, int e) {
  return e < c.n_ent - (c.target < a.S ? 1 : 0) ? __ldg(a.pull_tile + c.p0 + e)
                                                 : ~__ldg(a.sr + c.target);
}

// Issues the next piece of the warp's sequence (rows [i0, i0 + chunk) of
// entry e of the current item) into its stage, a lane per column, and
// commits one group, empty past the last piece. The next entry's tile id
// is loaded as the cursor moves, and first used at the next call.
__device__ void ring_issue(const Args& a, Ring& rg, int gwarp, int n_warps, int lane) {
  if (rg.live) {
    const int B = a.B, i1 = min(rg.i0 + a.chunk, B), rows = i1 - rg.i0;
    const float* tile = rg.id >= 0 ? a.tiles + static_cast<size_t>(rg.id) * B * B
                                   : a.diag + static_cast<size_t>(~rg.id) * B * B;
    const float* src = tile + static_cast<size_t>(rg.i0) * B;
    const uint32_t dst = smem_addr(rg.stage + (rg.issued % kRing) * kStage);
    for (int col = lane; col < B; col += kWarp) {
      const float* sp = src + col;
      uint32_t dp = dst + 4 * col;
#pragma unroll 4
      for (int r = 0; r < rows; ++r, sp += B, dp += 4 * (B + 1)) cp_async4(dp, sp);
    }
    rg.i0 = i1;
    if (rg.i0 == B) {
      rg.i0 = 0;
      if (++rg.e == rg.cur.n_ent) {
        rg.e = 0;
        rg.cur.item += n_warps;
        rg.live = seek(a, gwarp, n_warps, rg.cur);
      }
      if (rg.live) rg.id = piece_id(a, rg.cur, rg.e);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  ++rg.issued;
}

__device__ void ring_init(const Args& a, Ring& rg, float* stage, int gwarp, int n_warps,
                          int lane) {
  rg.stage = stage;
  rg.cur = Cursor{a.t_lo, gwarp, 0, 0, 0};
  rg.e = rg.i0 = 0;
  rg.issued = rg.used = 0;
  rg.live = seek(a, gwarp, n_warps, rg.cur);
  if (rg.live) rg.id = piece_id(a, rg.cur, 0);
  for (int i = 0; i < kRing - 1; ++i) ring_issue(a, rg, gwarp, n_warps, lane);
}

// The next piece, once it has landed; first issues the piece kRing - 1
// ahead into the stage the previous piece freed.
__device__ const float* ring_acquire(const Args& a, Ring& rg, int gwarp, int n_warps, int lane) {
  ring_issue(a, rg, gwarp, n_warps, lane);
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kRing - 1) : "memory");
  __syncwarp();  // every lane's copies of the piece are visible to the warp
  return rg.stage + (rg.used % kRing) * kStage;
}

__device__ __forceinline__ void ring_release(Ring& rg) {
  __syncwarp();
  ++rg.used;
}

// One resident work item: the pulls into s, then, for a solve slot, the
// column sweep, x and the flag. Each group of sources is awaited after the
// piece of its first tile is acquired, so the ring's look-ahead is issued
// before the wait.
template <bool kSplit>
__device__ void resident_item(const Args& a, Ring& rg, int gwarp, int n_warps, int target,
                              int row, int c, bool slot, float* s, float* xcs, int lane) {
  const int B = a.B, chunk = a.chunk;
  const Carry in = item_inputs<kSplit>(a, row, c, slot, s, lane);
  const int p0 = __ldg(a.pull_ptr + target), p1 = __ldg(a.pull_ptr + target + 1);
  if (p0 == p1) place(in, s, B, lane);
  for (int pg = p0; pg < p1; pg += kGather) {
    const int n = min(kGather, p1 - pg);
    const float* buf = ring_acquire(a, rg, gwarp, n_warps, lane);
    gather_sources(a, pg, n, c, xcs, lane);
    if (pg == p0) place(in, s, B, lane);
    for (int g = 0; g < n; ++g) {
      for (int i0 = 0; i0 < B; i0 += chunk) {
        if (g > 0 || i0 > 0) buf = ring_acquire(a, rg, gwarp, n_warps, lane);
        tile_rows(buf, B + 1, i0, min(i0 + chunk, B), xcs + g * B, s, B, lane);
        ring_release(rg);
      }
    }
  }
  store_sum<kSplit>(a, row, c, slot, in, s, lane);
  if (!slot) return;
  for (int i0 = 0; i0 < B; i0 += chunk) {
    const float* buf = ring_acquire(a, rg, gwarp, n_warps, lane);
    column_sweep(buf, B + 1, i0, min(i0 + chunk, B), s, lane);
    ring_release(rg);
  }
  store_x(a, row, c, s, lane);
}

// ---------------------------------------------------------------------------
// The streamed form: each warp's work items, in the order the warp runs
// them, arrive in shared memory by TMA bulk copies, one chunk ahead.
// ---------------------------------------------------------------------------

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

// A warp's double buffer. Its items' entries, cut into chunks of at most
// `cap`, form one sequence; chunk j lands in stage j % 2 and completes that
// stage's mbarrier for the (j / 2)-th time. While chunk j is computed,
// chunk j + 1 is in flight. Target k < S holds store entries from
// pull_ptr[k] + k, orphan q (target S + q) from pull_ptr[S + q] + S.
struct Stream {
  float* stage[2];
  uint32_t bar[2];
  Cursor cur;  // the item being issued
  int e;       // its first entry still to issue
  bool live;
  unsigned issued, used;  // chunks issued; chunks computed
};

__device__ void issue_next(const Args& a, Stream& st, int gwarp, int n_warps, int lane) {
  if (!st.live) return;  // the warp's last chunk is already in flight
  const int n = min(a.cap, st.cur.n_ent - st.e);
  const int first = st.cur.p0 + min(st.cur.target, a.S) + st.e;
  const int sl = st.issued & 1;
  if (lane == 0)
    bulk_load(smem_addr(st.stage[sl]), a.store + static_cast<size_t>(first) * a.stride,
              static_cast<uint32_t>(n) * a.stride * 4, st.bar[sl]);
  ++st.issued;
  st.e += n;
  if (st.e == st.cur.n_ent) {
    st.e = 0;
    st.cur.item += n_warps;
    st.live = seek(a, gwarp, n_warps, st.cur);
  }
}

__device__ void stream_init(const Args& a, Stream& st, uint64_t* bars, float* stages,
                            int gwarp, int n_warps, int lane) {
  st.stage[0] = stages;
  st.stage[1] = stages + stage_floats(a.cap, a.rows, a.B, a.stride);
  st.bar[0] = smem_addr(bars);
  st.bar[1] = smem_addr(bars + 1);
  if (lane == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(st.bar[i]) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  st.issued = st.used = 0;
  st.cur = Cursor{a.t_lo, gwarp, 0, 0, 0};
  st.e = 0;
  st.live = seek(a, gwarp, n_warps, st.cur);
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

// One item's entries through the warp's stages: tile(e) is entry e's tile,
// in order, acquiring the next stage when the held one is used up.
struct StreamedEntries {
  const float* buf = nullptr;
  int u = 0, held = 0;  // the next of the held stage's `held` entries

  __device__ const float* tile(const Args& a, Stream& st, int gwarp, int n_warps, int e,
                               int n_ent, int lane) {
    if (u == held) {
      if (buf) release(st);
      buf = acquire(a, st, gwarp, n_warps, lane);
      held = min(a.cap, n_ent - e);
      u = 0;
    }
    return buf + static_cast<size_t>(u++) * a.stride;  // rows B + 1 floats apart
  }
};

// ---------------------------------------------------------------------------
// The streamed form in row chunks (rows < B): one CTA per work item, its
// warps on one chunk sequence (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kSweepBar = 1;  // named barrier of sweep block m: kSweepBar + m (0 is the CTA's)

// The CTA's ring: kChunkStages stages of `rows` padded tile rows, stage k
// completing mbarrier k. Its work items' entries, each cut into chunks of
// `rows` tile rows (the last to the entry's padded end), form one
// sequence; chunk j lands in stage j % kChunkStages and completes that
// stage's mbarrier for the (j / kChunkStages)-th time. While chunk j is
// computed, chunks j + 1 .. j + kChunkStages - 1 are in flight. One
// thread, the producer, walks the items (the tables' dependent loads) and
// issues the copies: lane 0 of the last warp, which holds a chunk's last
// rows or none, so the walk stays off the warps that hold the first ones
// (warp 0 also waits for the sources, and the sweep starts there). Only
// the producer keeps the cursor; every thread counts the chunks it used.
struct ChunkRing {
  float* stage;  // stage k at stage + k rows (B + 1)
  uint32_t bar;  // mbarrier k at bar + 8 k
  Cursor cur;    // the producer's: the item being issued
  int e, i0;     // its entry and that entry's first row still to issue
  bool live;
  unsigned issued, used;  // chunks issued (the producer's); chunks computed
};

// Row chunks deal a level's work items round the grid in slot order: CTA
// u runs item `item` of the level whose first solve slot is o when
// (o R + item) mod n_ctas == u, so consecutive levels go to different CTAs
// and each CTA, its items still in level order, copies and computes what
// its next item needs from earlier levels while those levels finish. The
// first item of such a level that CTA u runs:
__device__ __forceinline__ int cta_first(int o, int R, int u, int n_ctas) {
  const int at = (o % n_ctas) * (R % n_ctas) % n_ctas;
  return u >= at ? u - at : u - at + n_ctas;
}

// seek() for the CTA's items as cta_first deals them.
__device__ bool cta_seek(const Args& a, int cta, int n_ctas, Cursor& c) {
  for (;;) {
    if (c.t < a.t_hi) {
      if (c.item < __ldg(a.wid + 3 * c.t) * a.R) {
        const int k = __ldg(a.off + 3 * c.t) + c.item / a.R;
        if (__ldg(a.sr + k) >= 0) {
          c.target = k;
          c.p0 = __ldg(a.pull_ptr + k);
          c.n_ent = __ldg(a.pull_ptr + k + 1) - c.p0 + 1;
          return true;
        }
        c.item += n_ctas;  // pad slot: no work, nothing copied
      } else if (++c.t < a.t_hi) {
        c.item = cta_first(__ldg(a.off + 3 * c.t), a.R, cta, n_ctas);
      } else {
        c.item = cta;
      }
    } else {
      if (c.item >= a.n_orphans * a.R) return false;
      c.target = a.S + c.item / a.R;
      c.p0 = __ldg(a.pull_ptr + c.target);
      c.n_ent = __ldg(a.pull_ptr + c.target + 1) - c.p0;
      return true;
    }
  }
}

__device__ __forceinline__ bool ring_producer() {
  return threadIdx.x == blockDim.x - kWarp;
}

// The producer issues the next chunk of the sequence into its stage (freed
// by the release of the chunk kChunkStages before it).
__device__ void ring_next(const Args& a, ChunkRing& rg, int cta, int n_ctas) {
  if (!ring_producer() || !rg.live) return;  // or the CTA's last chunk is already in flight
  const int first = rg.cur.p0 + min(rg.cur.target, a.S) + rg.e;
  const int i1 = min(rg.i0 + a.rows, a.B);
  const int from = rg.i0 * (a.B + 1), to = i1 == a.B ? a.stride : i1 * (a.B + 1);
  const int k = rg.issued % kChunkStages;
  bulk_load(smem_addr(rg.stage + static_cast<size_t>(k) * a.rows * (a.B + 1)),
            a.store + static_cast<size_t>(first) * a.stride + from,
            static_cast<uint32_t>(to - from) * 4, rg.bar + 8 * k);
  ++rg.issued;
  rg.i0 = i1 == a.B ? 0 : i1;
  if (rg.i0 == 0 && ++rg.e == rg.cur.n_ent) {
    rg.e = 0;
    rg.cur.item += n_ctas;
    rg.live = cta_seek(a, cta, n_ctas, rg.cur);
  }
}

// The producer initialises the mbarriers (at `smem`, the stages after
// them) and issues the first kChunkStages - 1 chunks; the CTA barrier shows
// the mbarriers to every warp before any waits.
__device__ void ring_start(const Args& a, ChunkRing& rg, unsigned char* smem, int cta,
                           int n_ctas) {
  rg.bar = smem_addr(smem);
  rg.stage = reinterpret_cast<float*>(smem + kChunkBarBytes);
  rg.issued = rg.used = 0;
  if (ring_producer()) {
    for (int k = 0; k < kChunkStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(rg.bar + 8 * k) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int first = a.t_lo < a.t_hi ? cta_first(__ldg(a.off + 3 * a.t_lo), a.R, cta, n_ctas)
                                      : cta;
    rg.cur = Cursor{a.t_lo, first, 0, 0, 0};
    rg.e = rg.i0 = 0;
    rg.live = cta_seek(a, cta, n_ctas, rg.cur);
    for (int k = 0; k + 1 < kChunkStages; ++k) ring_next(a, rg, cta, n_ctas);
  }
  __syncthreads();
}

// Every thread: the next chunk, once it has landed.
__device__ __forceinline__ const float* ring_wait(const Args& a, const ChunkRing& rg) {
  const int k = rg.used % kChunkStages;
  mbar_wait(rg.bar + 8 * k, (rg.used / kChunkStages) & 1);
  return rg.stage + static_cast<size_t>(k) * a.rows * (a.B + 1);
}

// The next chunk, once it has landed; the producer first issues the chunk
// kChunkStages - 1 after it into the stage the previous chunk freed.
__device__ __forceinline__ const float* ring_take(const Args& a, ChunkRing& rg, int cta,
                                                  int n_ctas) {
  ring_next(a, rg, cta, n_ctas);
  return ring_wait(a, rg);
}

// The CTA is done with the chunk: a CTA barrier shows every warp has read
// it, then the producer, which issues the copy that refills the stage,
// orders those reads (generic proxy) before it (async proxy).
__device__ __forceinline__ void ring_free(ChunkRing& rg) {
  __syncthreads();
  if (ring_producer()) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  ++rg.used;
}

// item_inputs for the CTA: thread t keeps row t's carry and b in registers,
// every other row's carry goes to s at once.
template <bool kSplit>
__device__ __forceinline__ Carry cta_item_inputs(const Args& a, int row, int c, bool slot,
                                                 float* s) {
  const int t = threadIdx.x;
  Carry in{0.f, 0.f};
  for (int j = t; j < a.B; j += blockDim.x) {
    const size_t at = (static_cast<size_t>(row) * a.B + j) * a.R + c;
    if (j == t) {
      in.acc = carry_in<kSplit>(a, at);
      if (slot) in.b = rhs_base<kSplit>(a, at);
    } else {
      s[j] = carry_in<kSplit>(a, at);
    }
  }
  return in;
}

// store_sum for the CTA. Thread t handles rows t, t + blockDim.x, ... here
// and in cta_item_inputs, so it reads only what it wrote itself or what a
// chunk's CTA barrier ordered before; the sweep's first chunk reads row i
// (< rows <= blockDim.x) in thread i, which wrote it here.
template <bool kSplit>
__device__ __forceinline__ void cta_store_sum(const Args& a, int row, int c, bool slot,
                                              const Carry& in, float* s) {
  const int t = threadIdx.x;
  for (int j = t; j < a.B; j += blockDim.x) {
    const size_t at = (static_cast<size_t>(row) * a.B + j) * a.R + c;
    if constexpr (kSplit)
      a.delta[at] = s[j];
    else
      a.acc[at] = s[j];
    if (slot) s[j] = (j == t ? in.b : rhs_base<kSplit>(a, at)) - s[j];
  }
}

// x[row, :, c] = s by every thread, then the flag: after the CTA barrier,
// the release store (cumulative) of lane 0 of the last warp but one orders
// every thread's x before the epoch it publishes. The release waits for
// the stores, so it is made off warp 0, which waits for the next sources,
// and off the ring's producer.
__device__ __forceinline__ void cta_store_x(const Args& a, int row, int c, const float* s) {
  for (int j = threadIdx.x; j < a.B; j += blockDim.x)
    a.x[(static_cast<size_t>(row) * a.B + j) * a.R + c] = s[j];
  __syncthreads();
  if (threadIdx.x == blockDim.x - 2 * kWarp)
    store_release(a.flags + static_cast<size_t>(row) * a.R + c, a.epoch);
}

// s[i0 + t] += (chunk row t) . xc for the chunk's n <= blockDim.x rows,
// thread t one row: tile_rows's FMA chain over the row in column order,
// unrolled so the shared loads run ahead of the chain; xc four floats a
// load where it is 16-byte aligned (B a multiple of four).
__device__ __forceinline__ void cta_tile_rows(const float* T, int ld, int i0, int n,
                                              const float* xc, float* s, int B) {
  const int t = threadIdx.x;
  if (t >= n) return;
  const float* ti = T + t * ld;
  float q = 0.f;
  if (B % 4 == 0) {
#pragma unroll 4
    for (int j = 0; j < B; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xc + j);
      q += ti[j] * v.x;
      q += ti[j + 1] * v.y;
      q += ti[j + 2] * v.z;
      q += ti[j + 3] * v.w;
    }
  } else {
#pragma unroll 8
    for (int j = 0; j < B; ++j) q += ti[j] * xc[j];
  }
  s[i0 + t] = s[i0 + t] + q;
}

// Rows [i0, i1) of the forward substitution, a chunk of at most 32 W rows
// (T its first row in shared memory, rows ld floats apart), warp k sweeping
// the chunk's 32-row block k, lane l its row l. Every warp first subtracts
// the columns of earlier chunks (j < i0) from its rows, all warps at once;
// then warp k, for each earlier block m of the chunk, waits for it on named
// barrier kSweepBar + m and applies its 32 columns, sweeps its own block as
// column_sweep does, and publishes it to the later blocks (bar.arrive: its
// stores of x are performed for them when the barrier completes). Row i so
// takes columns 0 .. i - 1 in order, then its division, as in
// column_sweep. Every block but the chunk's last is 32 rows.
__device__ void cta_sweep(const float* T, int ld, int i0, int i1, float* s) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int blocks = (i1 - i0 + kWarp - 1) / kWarp;
  if (warp >= blocks) return;
  const int j0 = i0 + warp * kWarp, n = min(kWarp, i1 - j0);
  const bool own = lane < n;
  const float* ti = T + (warp * kWarp + (own ? lane : 0)) * ld;
  float r = own ? s[j0 + lane] : 0.f;
  const float lii = own ? ti[j0 + lane] : 1.f;
#pragma unroll 8
  for (int j = 0; j < i0; ++j) r = fmaf(-ti[j], s[j], r);
  for (int m = 0; m < warp; ++m) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(kSweepBar + m), "r"(kWarp * (blocks - m))
                 : "memory");
    const int m0 = i0 + m * kWarp;
#pragma unroll 8
    for (int j = m0; j < m0 + kWarp; ++j) r = fmaf(-ti[j], s[j], r);
  }
#pragma unroll 4
  for (int o = 0; o < n; ++o) {
    const float xj = __shfl_sync(0xffffffffu, __fdiv_rn(r, lii), o);
    if (lane > o) r = fmaf(-ti[j0 + o], xj, r);
    if (lane == o) s[j0 + o] = xj;
  }
  __syncwarp();
  if (warp + 1 < blocks)
    asm volatile("bar.arrive %0, %1;\n" :: "r"(kSweepBar + warp), "r"(kWarp * (blocks - warp))
                 : "memory");
}

// One streamed work item whose tiles arrive in row chunks (rows < B), run
// by the whole CTA: resident_item's steps on the ring's chunks. For each
// group of sources the producer issues the next chunk, warp 0 waits for
// the sources and reads them while the group's first chunk lands, and a
// CTA barrier hands them to every warp.
template <bool kSplit>
__device__ void cta_item(const Args& a, ChunkRing& rg, int cta, int n_ctas, int target,
                         int row, int c, bool slot, float* s, float* xcs) {
  const int B = a.B, rows = a.rows, t = threadIdx.x;
  const Carry in = cta_item_inputs<kSplit>(a, row, c, slot, s);
  const int p0 = __ldg(a.pull_ptr + target), p1 = __ldg(a.pull_ptr + target + 1);
  if (p0 == p1 && t < B) s[t] = in.acc;
  for (int pg = p0, n; pg < p1; pg += n) {
    n = max(1, min(kGather, p1 - 1 - pg));  // the last pull, the newest source, alone
    ring_next(a, rg, cta, n_ctas);  // ring_take(), with the sources' wait inside it
    if (t < kWarp) gather_sources(a, pg, n, c, xcs, t);
    const float* buf = ring_wait(a, rg);
    __syncthreads();  // xcs holds the sources
    if (pg == p0 && t < B) s[t] = in.acc;
    for (int g = 0; g < n; ++g) {
      for (int i0 = 0; i0 < B; i0 += rows) {
        if (g > 0 || i0 > 0) buf = ring_take(a, rg, cta, n_ctas);
        cta_tile_rows(buf, B + 1, i0, min(rows, B - i0), xcs + g * B, s, B);
        ring_free(rg);
      }
    }
  }
  cta_store_sum<kSplit>(a, row, c, slot, in, s);
  if (!slot) return;
  for (int i0 = 0; i0 < B; i0 += rows) {
    cta_sweep(ring_take(a, rg, cta, n_ctas), B + 1, i0, min(i0 + rows, B), s);
    ring_free(rg);
  }
  cta_store_x(a, row, c, s);
}

// One streamed work item: resident_item's steps, operation for operation,
// on whole tiles as they arrive: the same tile_rows() and column_sweep()
// on the same values in the same order, so both forms give the same bits.
// Tiles wider than a stage go to cta_item.
template <bool kSplit>
__device__ void streamed_item(const Args& a, Stream& st, int gwarp, int n_warps, int target,
                              int row, int c, bool slot, float* s, float* xcs, int lane) {
  const int B = a.B;
  const Carry in = item_inputs<kSplit>(a, row, c, slot, s, lane);
  const int p0 = __ldg(a.pull_ptr + target), p1 = __ldg(a.pull_ptr + target + 1);
  const int n_ent = p1 - p0 + (slot ? 1 : 0);
  StreamedEntries ent;
  if (p0 == p1) place(in, s, B, lane);
  for (int pg = p0; pg < p1; pg += kGather) {
    const int n = min(kGather, p1 - pg);
    const float* T = ent.tile(a, st, gwarp, n_warps, pg - p0, n_ent, lane);
    gather_sources(a, pg, n, c, xcs, lane);
    if (pg == p0) place(in, s, B, lane);
    for (int g = 0; g < n; ++g) {
      if (g > 0) T = ent.tile(a, st, gwarp, n_warps, pg - p0 + g, n_ent, lane);
      tile_rows(T, B + 1, 0, B, xcs + g * B, s, B, lane);
    }
  }
  store_sum<kSplit>(a, row, c, slot, in, s, lane);
  if (slot) {
    const float* T = ent.tile(a, st, gwarp, n_warps, p1 - p0, n_ent, lane);
    for (int i0 = 0; i0 < B; i0 += kWarp)
      column_sweep(T + static_cast<size_t>(i0) * (B + 1), B + 1, i0, min(i0 + kWarp, B), s,
                   lane);
    store_x(a, row, c, s, lane);
  }
  release(st);
}

template <bool kStream, bool kSplit>
__global__ void __launch_bounds__(kMaxThreads) superstep_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  // The unit that runs a work item: a warp, or in row chunks the whole CTA
  // (every warp of it on the same items, with one set of stages).
  const bool cta = kStream && a.rows < a.B;
  const int gwarp = cta ? blockIdx.x : blockIdx.x * warps + warp;
  const int n_warps = cta ? gridDim.x : gridDim.x * warps;
  const int R = a.R, row_el = a.B * a.R;
  float* s;
  Stream st;
  ChunkRing cr;
  Ring rg;
  if constexpr (kStream) {
    if (cta) {
      s = reinterpret_cast<float*>(smem + kChunkBarBytes) +
          static_cast<size_t>(kChunkStages) * a.rows * (a.B + 1);
      ring_start(a, cr, smem, gwarp, n_warps);
    } else {
      float* stages = reinterpret_cast<float*>(smem + 16 * warps);
      const size_t two = 2 * stage_floats(a.cap, a.rows, a.B, a.stride);
      s = stages + warps * two + warp * (1 + kGather) * a.B;
      stream_init(a, st, reinterpret_cast<uint64_t*>(smem) + 2 * warp, stages + warp * two,
                  gwarp, n_warps, lane);
    }
  } else {
    float* mine = reinterpret_cast<float*>(smem) + warp * (kRing * kStage + (1 + kGather) * a.B);
    s = mine + kRing * kStage;
    ring_init(a, rg, mine, gwarp, n_warps, lane);
  }
  float* xcs = s + a.B;

  // rows the launch does not solve keep the incoming x (and, unless they
  // are orphans, the incoming acc); solved rows are written when solved.
  // kCopy elements per thread per pass, all loads before the stores. The
  // split form updates its carries in place: it copies nothing and needs no
  // grid barrier (a copy row's x is where it was before the launch).
  constexpr int kCopy = 8;
  if constexpr (!kSplit) {
    const size_t n_el = static_cast<size_t>(a.n_copy) * row_el;
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    for (size_t e0 = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e0 < n_el;
         e0 += kCopy * stride) {
      size_t at[kCopy];
      float va[kCopy], vx[kCopy];
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        const size_t e = e0 + u * stride;
        at[u] = e < n_el
                    ? static_cast<size_t>(__ldg(a.copy_row + e / row_el)) * row_el + e % row_el
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
    cg::this_grid().sync();  // the copy rows' x, read without waiting, is in place
  }

  // the level walk: each level's offset and width are loaded one level
  // ahead, so the walk adds no load latency between two items
  int o = 0, w = 0;
  if (a.t_lo < a.t_hi) {
    o = __ldg(a.off + 3 * a.t_lo);
    w = __ldg(a.wid + 3 * a.t_lo);
  }
  for (int t = a.t_lo; t < a.t_hi; ++t) {
    int o_next = 0, w_next = 0;
    if (t + 1 < a.t_hi) {
      o_next = __ldg(a.off + 3 * (t + 1));
      w_next = __ldg(a.wid + 3 * (t + 1));
    }
    for (int item = cta ? cta_first(o, R, gwarp, n_warps) : gwarp; item < w * R;
         item += n_warps) {
      const int k = o + item / R, c = item % R;
      const int row = __ldg(a.sr + k);
      if (row < 0) continue;  // pad slot
      if constexpr (!kStream)
        resident_item<kSplit>(a, rg, gwarp, n_warps, k, row, c, true, s, xcs, lane);
      else if (cta)
        cta_item<kSplit>(a, cr, gwarp, n_warps, k, row, c, true, s, xcs);
      else
        streamed_item<kSplit>(a, st, gwarp, n_warps, k, row, c, true, s, xcs, lane);
    }
    o = o_next;
    w = w_next;
  }

  for (int item = gwarp; item < a.n_orphans * R; item += n_warps) {
    const int q = item / R, row = __ldg(a.orphan_row + q);
    if constexpr (!kStream)
      resident_item<kSplit>(a, rg, gwarp, n_warps, a.S + q, row, item % R, false, s, xcs, lane);
    else if (cta)
      cta_item<kSplit>(a, cr, gwarp, n_warps, a.S + q, row, item % R, false, s, xcs);
    else
      streamed_item<kSplit>(a, st, gwarp, n_warps, a.S + q, row, item % R, false, s, xcs, lane);
  }
  if constexpr (!kStream) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Opts the kernel in to `bytes` of dynamic shared memory. A refusal is
// returned and cleared, so the next launch does not report it.
template <bool kStream, bool kSplit>
cudaError_t allow_shared(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      superstep_kernel<kStream, kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// CTAs of this kernel that can be resident at once on the current device;
// an error if the device has no cooperative launch.
template <bool kStream, bool kSplit>
cudaError_t resident_ctas(int threads, size_t smem, int* out) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_shared<kStream, kSplit>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, superstep_kernel<kStream, kSplit>, threads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  *out = per_sm * sms;
  return cudaSuccess;
}

// The grid a launch with grid <= 0 takes: enough units (warps, or in row
// chunks CTAs) for the widest phase's work items, no more CTAs than fit at
// once (`resident`).
int auto_grid(const Args& a, int warps, int max_items, int resident, bool stream) {
  const int per_cta = stream && a.rows < a.B ? 1 : warps;  // work items a CTA runs at once
  const int need = (max_items * a.R + per_cta - 1) / per_cta;
  return need < 1 ? 1 : (need < resident ? need : resident);
}

template <bool kStream, bool kSplit>
int launch(Args a, int warps, int max_items, int grid, void* stream) {
  if (a.epoch == 0) return cudaErrorInvalidValue;  // 0 is the value of a fresh flag
  const size_t smem =
      kStream ? streamed_bytes(warps, a.cap, a.rows, a.B, a.stride) : shared_bytes(a.B);
  int resident = 0;
  cudaError_t err = resident_ctas<kStream, kSplit>(warps * kWarp, smem, &resident);
  if (err != cudaSuccess) return err;
  if (grid <= 0) grid = auto_grid(a, warps, max_items, resident, kStream);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(superstep_kernel<kStream, kSplit>), dim3(grid),
      dim3(warps * kWarp), params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the refusal, or the next launch would report it
    return err;
  }
  return cudaGetLastError();
}

// The streamed shape's rule (kernels/superstep.py::streamed_shape): whole
// entries (rows == B), or row chunks of a multiple of four rows, one entry
// per stage, for a CTA of chunk_warps(B) warps with at most one chunk row a
// thread (so at most one sweep block a warp); the CTA within the shared
// memory; the blocks the resident form takes.
bool streamed_shape_ok(int warps, int cap, int rows, int B, int stride) {
  if (B < 1 || B >= kStage || warps < 1 || warps > kWarpsPerCta || cap < 1 || rows < 1 ||
      rows > B)
    return false;
  if (rows < B &&
      (rows % 4 != 0 || cap != 1 || warps != chunk_warps(B) || rows > warps * kWarp))
    return false;
  return streamed_bytes(warps, cap, rows, B, stride) <= kSharedLimit;
}

int launch_resident(const int* off, const int* wid, const int* sr, const int* pull_ptr,
                    const int* pull_tile, const int* pull_col, const int* pull_wait,
                    const int* orphan_row, const int* copy_row, const float* diag,
                    const float* tiles, const float* b, const float* acc_in, const float* x_in,
                    float* acc, float* x, int* flags, int t_lo, int t_hi, int B, int R, int S,
                    int n_orphans, int n_copy, int max_items, int grid, int epoch, void* stream) {
  if (B < 1 || B >= kStage || R < 1) return cudaErrorInvalidValue;
  const int chunk = kStage / (B + 1) < B ? kStage / (B + 1) : B;  // at most 32 rows
  Args a{off,   wid,   sr,      pull_ptr, pull_tile, pull_col, pull_wait, orphan_row, copy_row,
         diag,  tiles, nullptr, b,        acc_in,    x_in,     acc,       nullptr,    x,
         flags, t_lo,  t_hi,    B,        R,         S,        n_orphans, n_copy,     0,
         0,     0,     chunk,   epoch};
  return launch<false, false>(a, kWarpsPerCta, max_items, grid, stream);
}

// The split form of either store, in place: acc is read, delta and x are
// updated where they lie, nothing is copied.
template <bool kStream>
int launch_split(const int* off, const int* wid, const int* sr, const int* pull_ptr,
                 const int* pull_tile, const int* pull_col, const int* pull_wait,
                 const int* orphan_row, const float* diag, const float* tiles,
                 const float* store, const float* b, const float* acc, float* delta, float* x,
                 int* flags, int t_lo, int t_hi, int B, int R, int S, int n_orphans,
                 int max_items, int grid, int warps, int cap, int rows, int epoch,
                 void* stream) {
  const int stride = (B * (B + 1) + 3) / 4 * 4;
  const int chunk = kStage / (B + 1) < B ? kStage / (B + 1) : B;
  if (B < 1 || R < 1) return cudaErrorInvalidValue;
  if (kStream ? !streamed_shape_ok(warps, cap, rows, B, stride) : B >= kStage)
    return cudaErrorInvalidValue;
  if (kStream && reinterpret_cast<uintptr_t>(store) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (delta == x || static_cast<const float*>(delta) == acc ||
      static_cast<const float*>(x) == acc)
    return cudaErrorInvalidValue;  // three carries, three buffers
  Args a{off,   wid,   sr,    pull_ptr, pull_tile, pull_col, pull_wait, orphan_row, nullptr,
         diag,  tiles, store, b,        acc,       x,        nullptr,   delta,      x,
         flags, t_lo,  t_hi,  B,        R,         S,        n_orphans, 0,          cap,
         stride, rows, chunk, epoch};
  return launch<kStream, true>(a, kStream ? warps : kWarpsPerCta, max_items, grid, stream);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the launch's CUDA error
// (0 on success); it never synchronises. grid <= 0 sizes the grid itself.
// `flags` is the (n_rows R,) scratch of kernels/superstep.py::ReadyFlags and
// `epoch` its value for this launch (not 0, and no flag may hold it yet).
int repro_superstep_f32(const int* off, const int* wid, const int* sr, const int* pull_ptr,
                        const int* pull_tile, const int* pull_col, const int* pull_wait,
                        const int* orphan_row, const int* copy_row, const float* diag,
                        const float* tiles, const float* b, const float* acc_in,
                        const float* x_in, float* acc, float* x, int* flags, int t_lo, int t_hi,
                        int B, int S, int n_orphans, int n_copy, int max_items, int grid,
                        int epoch, void* stream) {
  return launch_resident(off, wid, sr, pull_ptr, pull_tile, pull_col, pull_wait, orphan_row,
                         copy_row, diag, tiles, b, acc_in, x_in, acc, x, flags, t_lo, t_hi, B, 1,
                         S, n_orphans, n_copy, max_items, grid, epoch, stream);
}

int repro_superstep_panel_f32(const int* off, const int* wid, const int* sr,
                              const int* pull_ptr, const int* pull_tile, const int* pull_col,
                              const int* pull_wait, const int* orphan_row, const int* copy_row,
                              const float* diag, const float* tiles, const float* b,
                              const float* acc_in, const float* x_in, float* acc, float* x,
                              int* flags, int t_lo, int t_hi, int B, int R, int S, int n_orphans,
                              int n_copy, int max_items, int grid, int epoch, void* stream) {
  return launch_resident(off, wid, sr, pull_ptr, pull_tile, pull_col, pull_wait, orphan_row,
                         copy_row, diag, tiles, b, acc_in, x_in, acc, x, flags, t_lo, t_hi, B, R,
                         S, n_orphans, n_copy, max_items, grid, epoch, stream);
}

// The streamed form: `store` is the streamed store (kernels/superstep.py::
// streamed_values), entries of round_up(B (B + 1), 4) floats; `warps` per
// CTA, `cap` entries per stage and `rows` tile rows per stage (B: whole
// tiles) come from kernels/superstep.py::streamed_shape. Vectors and (n, R)
// panels alike.
int repro_superstep_streamed_f32(const int* off, const int* wid, const int* sr,
                                 const int* pull_ptr, const int* pull_col, const int* pull_wait,
                                 const int* orphan_row, const int* copy_row, const float* store,
                                 const float* b, const float* acc_in, const float* x_in,
                                 float* acc, float* x, int* flags, int t_lo, int t_hi, int B,
                                 int R, int S, int n_orphans, int n_copy, int max_items,
                                 int grid, int warps, int cap, int rows, int epoch,
                                 void* stream) {
  const int stride = (B * (B + 1) + 3) / 4 * 4;
  if (R < 1 || !streamed_shape_ok(warps, cap, rows, B, stride)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(store) % 16 != 0) return cudaErrorMisalignedAddress;
  Args a{off,   wid,     sr,      pull_ptr, nullptr, pull_col, pull_wait, orphan_row, copy_row,
         nullptr, nullptr, store,   b,       acc_in,  x_in,     acc,       nullptr,    x,
         flags, t_lo,    t_hi,    B,       R,       S,        n_orphans, n_copy,     cap,
         stride, rows,    0,       epoch};
  return launch<true, false>(a, warps, max_items, grid, stream);
}

// The split form (superstep_split_ in kernels/superstep.py), resident
// (diag, tiles) or streamed (store; warps and cap as above), vectors and
// (n, R) panels alike. It updates its carries in place: b and acc are read,
// delta (the pulls' sums) and x (the solved rows) are written where they
// lie, and no other row is touched. S is the end of the launch's solve
// slots: orphan q is target S + q. pull_ptr is indexed by target, so the
// caller passes it offset to the launch's part of a longer table.
int repro_superstep_split_f32(const int* off, const int* wid, const int* sr,
                              const int* pull_ptr, const int* pull_tile, const int* pull_col,
                              const int* pull_wait, const int* orphan_row, const float* diag,
                              const float* tiles, const float* b, const float* acc,
                              float* delta, float* x, int* flags, int t_lo, int t_hi, int B,
                              int R, int S, int n_orphans, int max_items, int grid, int epoch,
                              void* stream) {
  return launch_split<false>(off, wid, sr, pull_ptr, pull_tile, pull_col, pull_wait, orphan_row,
                             diag, tiles, nullptr, b, acc, delta, x, flags, t_lo, t_hi, B, R, S,
                             n_orphans, max_items, grid, kWarpsPerCta, 0, 0, epoch, stream);
}

int repro_superstep_streamed_split_f32(const int* off, const int* wid, const int* sr,
                                       const int* pull_ptr, const int* pull_col,
                                       const int* pull_wait, const int* orphan_row,
                                       const float* store, const float* b, const float* acc,
                                       float* delta, float* x, int* flags, int t_lo, int t_hi,
                                       int B, int R, int S, int n_orphans, int max_items,
                                       int grid, int warps, int cap, int rows, int epoch,
                                       void* stream) {
  return launch_split<true>(off, wid, sr, pull_ptr, nullptr, pull_col, pull_wait, orphan_row,
                            nullptr, nullptr, store, b, acc, delta, x, flags, t_lo, t_hi, B, R, S,
                            n_orphans, max_items, grid, warps, cap, rows, epoch, stream);
}

// The dynamic shared memory a launch requests: the resident form's
// (streamed == 0), or the streamed form's with `warps` per CTA, `cap`
// entries and `rows` tile rows per stage. The rule the launches above
// apply, for the host to check its own copy of it against
// (repro_torch.verify, kc.scratch.shape).
size_t repro_superstep_shared_bytes(int streamed, int warps, int cap, int rows, int B) {
  return streamed ? streamed_bytes(warps, cap, rows, B, (B * (B + 1) + 3) / 4 * 4)
                  : shared_bytes(B);
}

// The grid (CTAs; threads per CTA: 32 warps) a streamed launch of that
// shape with grid <= 0 takes for `max_items` work items of R columns, or a
// negative CUDA error: the rule launch() applies, for the host to check.
int repro_superstep_streamed_grid(int warps, int cap, int rows, int B, int R, int max_items) {
  const int stride = (B * (B + 1) + 3) / 4 * 4;
  if (R < 1 || !streamed_shape_ok(warps, cap, rows, B, stride)) return -cudaErrorInvalidValue;
  Args a{};
  a.B = B;
  a.R = R;
  a.cap = cap;
  a.stride = stride;
  a.rows = rows;
  int resident = 0;
  const cudaError_t err = resident_ctas<true, false>(
      warps * kWarp, streamed_bytes(warps, cap, rows, B, stride), &resident);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return auto_grid(a, warps, max_items, resident, true);
}

// Weak: every source defines it, so the sources also link into one module.
__attribute__((weak)) const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
