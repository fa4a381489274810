#!/usr/bin/env python3
"""Device time of the TRSM (``csrc/block_trsv.cu``) for designs of it.

    python3 perf/trsm_variants.py [--parent DIR] [--variants base tile ...]
                                  [--k 32 4096] [--B 16 32 64] [--R 1 2 8 16]

Times ``block_trsm`` and ``torch.linalg.solve_triangular`` at every (k, B,
R): device ms per call, ``torch.profiler``'s ``key_averages()`` over 50
calls of the named kernel alone (as ``chip_smoke.py`` reads them). The
default k are the main path's widest level (32 tiles) and a wide batch
(4096). Each design is an edit of a copy of ``src/`` under
``build/trsm_variants/<variant>/`` (the checkout is not touched), built
fresh:

* ``base``: the kernels as they are (B <= 32: one warp per right-hand-side
  column, each holding the tile's columns in registers);
* ``tile``: one warp per tile carrying its R columns' chains interleaved, 8
  at a time (then 4, 2, 1 for the rest), four tiles per CTA;
* ``tile1``: ``tile`` with one tile per CTA;
* ``xpose``: one warp per tile, its columns (8 at a time, then 4, 2, 1)
  reduced together by a transpose-reduce across columns (18 shuffles a
  row for 8 columns, not 40), each division on the lanes that hold that
  column's sum, the quotients gathered to lane i; four tiles per CTA.

B > 32 runs ``trsm_wide_kernel`` in every design. Every design computes the
same bits; before timing, each tree's TRSM columns are checked bit for bit
against its TRSV of that column and, at B <= 32, against this checkout's
``ref.rowsweep_bits_ref`` on the host (``bits=ok`` or ``bits=DIFFER`` on
its lines). ``--parent DIR`` also times the kernels of another checkout of
the repository (for example ``git archive`` of the parent commit unpacked
into ``build/parent/``), built in its own ``build/``. Prints the card line,
each tree's registers and spills from ``ptxas``, and one line per tree and
shape: ``[trsm] <tree> k=.. B=.. R=.. bits=.. trsm=.. lib=..``. Needs a
CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from variant_trees import device_ms, oracles, replace_once, run_trees, variant_tree

TRSM_RE = r"(?<![A-Za-z_])trsm_\w*kernel"  # trsm_kernel, trsm_wide_kernel, the parent's
LIBRARY_RE = r"(?i)gemm|gemv|trsm|trsv|xmma|cutlass|cublas|sm90_"  # as chip_smoke.py

TILE_SWEEP = """\
// Columns c0 .. c0 + N - 1 of one tile, their N chains interleaved; rt and
// xt are the tile's (B,R) blocks of r and x.
template <int N>
__device__ __forceinline__ void sweep_columns(const float (&Lc)[kWarp], float d, int B, int lane,
                                              const float* __restrict__ rt,
                                              float* __restrict__ xt, int R, int c0) {
  float rc[N], xc[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    rc[c] = lane < B ? __ldg(rt + lane * R + c0 + c) : 0.f;
    xc[c] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kWarp; ++i) {
    if (i < B) {
      float p[N];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        p[c] = 0.f;
        if (lane < i) p[c] += Lc[i] * xc[c];
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1)
#pragma unroll
        for (int c = 0; c < N; ++c) p[c] += __shfl_xor_sync(kFull, p[c], o);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const float q = __fdiv_rn(rc[c] - p[c], d);
        if (lane == i) xc[c] = q;
      }
    }
  }
  if (lane < B)
#pragma unroll
    for (int c = 0; c < N; ++c) xt[lane * R + c0 + c] = xc[c];
}
"""
XPOSE_SWEEP = """\
// One offset O of the butterfly for N columns at once. While more than one
// column is live the lane keeps H = N * O / 32 of its 2H live slots (the
// upper half when bit O of the lane is set) and adds what lane l ^ O sends
// for them, as transpose_reduce does for rows; then it is the butterfly's
// step on slot 0. Each column meets the butterfly's pairs in its order.
template <int N, int O>
__device__ __forceinline__ void column_step(float (&v)[N], int lane) {
  constexpr int H = N * O / kWarp;
  if constexpr (H == 0) {
    v[0] += __shfl_xor_sync(kFull, v[0], O);
  } else {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float send = upper ? v[k] : v[k + H];
      const float keep = upper ? v[k + H] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, O);
    }
  }
}

// Columns c0 .. c0 + N - 1 of one tile, reduced together: after the five
// steps lane l holds the sum of column l / (32 / N), divides it with that
// column's r[i] (rc, the lane's column of r) by L[i][i] (from lane i), and
// lane i gathers the N quotients; rt and xt are the tile's (B,R) blocks.
template <int N>
__device__ __forceinline__ void sweep_columns(const float (&Lc)[kWarp], float d, int B, int lane,
                                              const float* __restrict__ rt,
                                              float* __restrict__ xt, int R, int c0) {
  constexpr int S = kWarp / N;  // lanes per column after the reduction
  float rc[kWarp], xc[N];
#pragma unroll
  for (int s = 0; s < kWarp; ++s) rc[s] = s < B ? __ldg(rt + s * R + c0 + lane / S) : 0.f;
#pragma unroll
  for (int c = 0; c < N; ++c) xc[c] = 0.f;
#pragma unroll
  for (int i = 0; i < kWarp; ++i) {
    if (i < B) {
      float v[N];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        v[c] = 0.f;
        if (lane < i) v[c] += Lc[i] * xc[c];
      }
      column_step<N, 16>(v, lane);
      column_step<N, 8>(v, lane);
      column_step<N, 4>(v, lane);
      column_step<N, 2>(v, lane);
      column_step<N, 1>(v, lane);
      const float q = __fdiv_rn(rc[i] - v[0], __shfl_sync(kFull, d, i));
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const float xi = __shfl_sync(kFull, q, c * S);
        if (lane == i) xc[c] = xi;
      }
    }
  }
  if (lane < B)
#pragma unroll
    for (int c = 0; c < N; ++c) xt[lane * R + c0 + c] = xc[c];
}
"""
TILE_KERNEL = """\
constexpr int kTrsmTiles = {tiles};  // tiles (warps) per CTA

{sweep}
__global__ void __launch_bounds__(kTrsmTiles * kWarp)
    trsm_kernel(const float* __restrict__ L, const float* __restrict__ r, float* __restrict__ x,
                int k, int B, int R) {{
  const size_t t = static_cast<size_t>(blockIdx.x) * kTrsmTiles + threadIdx.x / kWarp;
  if (t >= static_cast<size_t>(k)) return;  // the whole warp
  const int lane = threadIdx.x % kWarp;
  float Lc[kWarp], d;
  load_column(L + t * B * B, B, lane, Lc, d);
  const float* rt = r + t * B * R;
  float* xt = x + t * B * R;
  int c = 0;
  for (; c + 8 <= R; c += 8) sweep_columns<8>(Lc, d, B, lane, rt, xt, R, c);
  if (R - c >= 4) {{
    sweep_columns<4>(Lc, d, B, lane, rt, xt, R, c);
    c += 4;
  }}
  if (R - c >= 2) {{
    sweep_columns<2>(Lc, d, B, lane, rt, xt, R, c);
    c += 2;
  }}
  if (R - c >= 1) sweep_columns<1>(Lc, d, B, lane, rt, xt, R, c);
}}
"""
BASE_LAUNCH = "trsm_kernel<<<k, warps * kWarp, 0, s>>>(L, r, x, B, R);"
TILE_LAUNCH = "trsm_kernel<<<(k + kTrsmTiles - 1) / kTrsmTiles, kTrsmTiles * kWarp, 0, s>>>(" \
              "L, r, x, k, B, R);"


def tile_edit(sweep: str, tiles: int):
    """``trsm_kernel`` replaced by a one-warp-per-tile design."""
    def edit(src: str) -> str:
        start = src.index("__global__ void __launch_bounds__(kMaxTrsmWarps * kWarp)\n"
                          "    trsm_kernel(")
        end = src.index("\n}\n", start) + 3
        src = src[:start] + TILE_KERNEL.format(tiles=tiles, sweep=sweep) + src[end:]
        return replace_once(src, BASE_LAUNCH, TILE_LAUNCH)
    return edit


VARIANTS = {"base": None, "tile": tile_edit(TILE_SWEEP, 4), "tile1": tile_edit(TILE_SWEEP, 1),
            "xpose": tile_edit(XPOSE_SWEEP, 4)}


def time_tree(src: Path, label: str, ks: list[int], Bs: list[int], Rs: list[int]) -> None:
    """Child process: check and time one tree's TRSM."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.kernels import block_trsv as k

    ref = oracles()

    gen = torch.Generator(device="cuda").manual_seed(0)
    for kk in ks:
        for B in Bs:
            eye = torch.eye(B, device="cuda")
            L = torch.tril(torch.rand(kk, B, B, device="cuda", generator=gen) * 2 - 1, -1) / B
            L += 2 * eye
            for R in Rs:
                r = torch.rand(kk, B, R, device="cuda", generator=gen) * 2 - 1
                x = k.block_trsm(L, r)
                bits = all(torch.equal(x[..., c], k.block_trsv(L, r[..., c].contiguous()))
                           for c in range(R))
                if B <= ref.WARP:
                    bits = bits and torch.equal(x.cpu(), ref.rowsweep_bits_ref(L.cpu(), r.cpu()))
                times = {"trsm": device_ms(lambda: k.block_trsm(L, r), TRSM_RE),
                         "lib": device_ms(lambda: torch.linalg.solve_triangular(L, r, upper=False),
                                          LIBRARY_RE)}
                print(f"[trsm] {label} k={kk} B={B} R={R} bits={'ok' if bits else 'DIFFER'} "
                      + " ".join(f"{n}={t}" for n, t in times.items()), flush=True)
            del L
            torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    parser.add_argument("--parent", type=Path, help="another checkout, timed as 'parent'")
    parser.add_argument("--k", type=int, nargs="+", default=[32, 4096])
    parser.add_argument("--B", type=int, nargs="+", default=[16, 32, 64])
    parser.add_argument("--R", type=int, nargs="+", default=[1, 2, 8, 16])
    parser.add_argument("--time", nargs=2, metavar=("SRC", "LABEL"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time:
        time_tree(Path(args.time[0]), args.time[1], args.k, args.B, args.R)
        return

    trees = [(name, None) for name in args.variants]
    if args.parent:
        trees.insert(0, ("parent", args.parent.resolve()))
    run_trees("trsm", Path(__file__).resolve(), "block_trsv", trees,
              lambda name: variant_tree("trsm_variants", name, "block_trsv", VARIANTS[name]),
              ["--k", *map(str, args.k), "--B", *map(str, args.B), "--R", *map(str, args.R)])


if __name__ == "__main__":
    main()
