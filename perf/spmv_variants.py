#!/usr/bin/env python3
"""Device time of the GEMV family (``csrc/block_spmv.cu``) for variants of it.

    python3 perf/spmv_variants.py [--parent DIR] [--variants base natural ...]
                                  [--B 32 64 128] [--m 64 15857]

Times the GEMM (``gemm_kernel``, or ``gemm_wide_kernel`` for B > 32; R =
8), the grouped GEMV (G = 8), the GEMV (``block_gemv``: ``gemv_grouped_kernel``
at ``kGemvTiles`` tiles per CTA; the parent's ``gemv_kernel``) and
``torch.bmm`` (R = 8 and R = 1) at each B and tile count m: device ms per call,
``torch.profiler``'s ``key_averages()`` over 50 calls of the named kernel
alone (as ``chip_smoke.py`` reads them). The default m are the main path's
widest level (64 tiles) and the IC(0)-PCG SpMV's tile count (15,857 at B =
32); every B uses the same m. Each variant is an edit of a copy of ``src/``
under ``build/spmv_variants/<variant>/`` (the checkout is not touched),
built fresh:

* ``base``: the kernels as they are (the GEMV one tile per CTA);
* ``gemv4``: the GEMV four tiles per CTA (one warp each, as the GEMM's
  grid) instead of one;
* ``natural``: ``gemm_kernel``'s tile registers kept in natural row order,
  reduced with two selects per shuffle (``transpose_reduce<false>``, as
  ``warp_rows_dot`` does), instead of permuted once per tile into xor order
  (slot s holds row s ^ lane) and reduced with none;
* ``scalar``: ``gemm_kernel``'s X and Y read and written one float at a
  time instead of as float4 when R % 4 == 0;
* ``lb5``: ``gemm_kernel``'s ``__launch_bounds__`` asks for 5 CTAs per SM;
* ``w8``: 8 tiles (warps) per GEMM CTA instead of 4;
* ``pf1``, ``pf2``: ``gemm_kernel`` on a persistent grid (as many CTAs as
  fit on the card at once), each warp looping over tiles with the next one
  (pf1) or two (pf2) tiles' registers loaded ahead; ``pf1w8``: pf1 with 8
  warps per CTA;
* ``rc1``, ``rc2``: ``gemm_wide_kernel`` (B > 32) taking 1 or 2 columns per
  pass over a 32-row block instead of 4;
* ``shared``: ``gemm_wide_kernel`` with each tile taken by the CTA's warps
  together, one (32-row block, column) pair per warp in turn, instead of by
  one warp.

Every variant computes the same bits; before timing, each tree's GEMM
columns and grouped GEMV are checked bit for bit against its GEMV at every
B, and at B <= 32 its GEMV and GEMM against this checkout's
``ref.gemv_bits_ref`` on the host (``bits=ok`` or ``bits=DIFFER`` on its
lines). ``--parent DIR`` also
times the kernels of another checkout of the repository (for example
``git archive`` of the parent commit unpacked into ``build/parent/``), built
in its own ``build/``. Prints the card line, each variant's registers and
spills from ``ptxas``, and one line per tree, B and m:
``[spmv] <tree> B=.. m=.. bits=.. gemm=.. grouped=.. gemv=.. bmm8=.. bmm1=..``.
Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from variant_trees import device_ms, edits, oracles, replace_once, run_trees, variant_tree

R_GEMM, GROUP = 8, 8
KERNEL_RE = r"(?<![A-Za-z_]){}(?=[(E ]|$)"  # as chip_smoke.py::DEVICE_KERNEL
LIBRARY_RE = r"(?i)gemm|gemv|xmma|cutlass|cublas|sm90_"

GEMM_RE = r"(?<![A-Za-z_])gemm_(?:wide_)?kernel(?=[(E ]|$)"
GEMV_RE = r"(?<![A-Za-z_])gemv_(?:grouped_)?kernel(?=[(E ]|$)"  # the parent's is gemv_kernel
GEMM_LAUNCH = "gemm_kernel<<<grid,"
XOR_SWAPS = "".join(f"  xor_swap<{o}>(tr, lane);\n" for o in (16, 8, 4, 2, 1))
WIDE_BODY = """\
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
"""
SHARED_BODY = """\
  const int pairs = (B + kWarp - 1) / kWarp * R;  // (32-row block, column) pairs
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kGemmWarps;
  for (size_t t = t0; t < t0 + kGemmWarps && t < static_cast<size_t>(m); ++t)
    for (int p = threadIdx.x / kWarp; p < pairs; p += kGemmWarps)
      gemm_rows<1>(T + t * B * B, X + t * B * R, Y + t * B * R, B, R, p / R * kWarp, p % R,
                   lane);
"""


def prefetch_kernel(depth: int) -> str:
    """``gemm_kernel`` on a persistent grid: each warp walks tiles first,
    first + stride, ... and keeps the next ``depth`` tiles' registers loaded
    ahead; plus the host function that sizes the grid."""
    return f"""\
constexpr int kPrefetch = {depth};

__device__ __forceinline__ void load_tile(const float* __restrict__ T, size_t u, size_t m, int B,
                                          int lane, float (&d)[kWarp]) {{
#pragma unroll
  for (int s = 0; s < kWarp; ++s)
    d[s] = lane < B && s < B && u < m ? __ldg(T + u * B * B + s * B + lane) : 0.f;
}}

__global__ void __launch_bounds__(kGemmWarps * kWarp)
    gemm_kernel(const float* __restrict__ T, const float* __restrict__ X, float* __restrict__ Y,
                int m, int B, int R, bool vec) {{
  const int lane = threadIdx.x % kWarp;
  const size_t mm = static_cast<size_t>(m);
  const size_t stride = static_cast<size_t>(gridDim.x) * kGemmWarps;
  const size_t first = static_cast<size_t>(blockIdx.x) * kGemmWarps + threadIdx.x / kWarp;
  const bool mine = lane < B;
  float nx[kPrefetch][kWarp];
#pragma unroll
  for (int d = 0; d < kPrefetch; ++d) load_tile(T, first + d * stride, mm, B, lane, nx[d]);
  for (size_t t = first; t < mm; t += stride) {{
    float tr[kWarp];
#pragma unroll
    for (int s = 0; s < kWarp; ++s) tr[s] = nx[0][s];
#pragma unroll
    for (int d = 0; d + 1 < kPrefetch; ++d)
#pragma unroll
      for (int s = 0; s < kWarp; ++s) nx[d][s] = nx[d + 1][s];
    load_tile(T, t + kPrefetch * stride, mm, B, lane, nx[kPrefetch - 1]);
{XOR_SWAPS}    const float* Xt = X + t * B * R;
    float* Yt = Y + t * B * R;
    for (int c0 = 0; c0 < R; c0 += kCols) {{
      const int n = min(kCols, R - c0);
      float xr[kCols] = {{}}, yr[kCols] = {{}};
      if (mine) load_cols(Xt + static_cast<size_t>(lane) * R + c0, n, vec, xr);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {{
        if (i < n) {{
          float v[kWarp];
#pragma unroll
          for (int s = 0; s < kWarp; ++s) v[s] = __fmaf_rn(tr[s], xr[i], 0.f);
          yr[i] = transpose_reduce<true>(v, lane);
        }}
      }}
      if (mine) store_cols(Yt + static_cast<size_t>(lane) * R + c0, n, vec, yr);
    }}
  }}
}}

int persistent_grid(int m) {{
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_kernel, kGemmWarps * kWarp, 0);
  const int ctas = (m + kGemmWarps - 1) / kGemmWarps;
  return ctas < sms * per_sm ? ctas : sms * per_sm;
}}
"""


def gemm_kernel_span(src: str) -> tuple[int, int]:
    """Start and end of ``gemm_kernel``'s definition in ``src``."""
    start = src.index("__global__ void __launch_bounds__(kGemmWarps * kWarp)\n    gemm_kernel(")
    return start, src.index("\n}\n", start) + 3


def prefetch_edit(depth: int):
    def edit(src: str) -> str:
        start, end = gemm_kernel_span(src)
        src = src[:start] + prefetch_kernel(depth) + src[end:]
        return replace_once(src, GEMM_LAUNCH, "gemm_kernel<<<persistent_grid(m),")
    return edit


VARIANTS = {
    "base": None,
    "gemv4": edits(("constexpr int kGemvTiles = 1;", "constexpr int kGemvTiles = 4;")),
    "natural": edits((XOR_SWAPS, ""), ("transpose_reduce<true>(v, lane)",
                                       "transpose_reduce<false>(v, lane)")),
    "scalar": edits(("const bool vec = R % 4 == 0 &&", "const bool vec = false &&")),
    "lb5": edits(("__launch_bounds__(kGemmWarps * kWarp)\n    gemm_kernel(",
                  "__launch_bounds__(kGemmWarps * kWarp, 5)\n    gemm_kernel(")),
    "w8": edits(("constexpr int kGemmWarps = 4;", "constexpr int kGemmWarps = 8;")),
    "pf1": prefetch_edit(1),
    "pf2": prefetch_edit(2),
    "pf1w8": lambda src: prefetch_edit(1)(VARIANTS["w8"](src)),
    "rc1": edits(("constexpr int kRowCols = 4;", "constexpr int kRowCols = 1;")),
    "rc2": edits(("constexpr int kRowCols = 4;", "constexpr int kRowCols = 2;")),
    "shared": edits((WIDE_BODY, SHARED_BODY)),
}


def time_tree(src: Path, label: str, Bs: list[int], ms: list[int]) -> None:
    """Child process: check and time one tree's kernels."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.kernels import block_spmv as k

    ref = oracles()

    gen = torch.Generator(device="cuda").manual_seed(0)

    def uniform(*shape):
        return torch.rand(shape, device="cuda", generator=gen) * 2 - 1

    for B in Bs:
        T, X = uniform(17, B, B), uniform(17, B, R_GEMM)
        Y, x = k.block_gemm(T, X), X[..., 0].contiguous()
        bits = (all(torch.equal(Y[..., c], k.block_gemv(T, X[..., c].contiguous()))
                    for c in range(R_GEMM))
                and torch.equal(k.block_gemv_grouped(T, x, GROUP), k.block_gemv(T, x)))
        if B <= ref.WARP:
            bits = (bits and torch.equal(Y.cpu(), ref.gemv_bits_ref(T.cpu(), X.cpu()))
                    and torch.equal(k.block_gemv(T, x).cpu(), ref.gemv_bits_ref(T.cpu(), x.cpu())))
        for m in ms:
            T, X, x = uniform(m, B, B), uniform(m, B, R_GEMM), uniform(m, B)
            times = {
                "gemm": device_ms(lambda: k.block_gemm(T, X), GEMM_RE),
                "grouped": device_ms(lambda: k.block_gemv_grouped(T, x, GROUP),
                                     KERNEL_RE.format("gemv_grouped_kernel")),
                "gemv": device_ms(lambda: k.block_gemv(T, x), GEMV_RE),
                "bmm8": device_ms(lambda: torch.bmm(T, X), LIBRARY_RE),
                "bmm1": device_ms(lambda: torch.bmm(T, x.unsqueeze(-1)), LIBRARY_RE)}
            print(f"[spmv] {label} B={B} m={m} bits={'ok' if bits else 'DIFFER'} "
                  + " ".join(f"{n}={t}" for n, t in times.items()), flush=True)
            del T, X, x
            torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    parser.add_argument("--parent", type=Path, help="another checkout, timed as 'parent'")
    parser.add_argument("--B", type=int, nargs="+", default=[32, 64, 128])
    parser.add_argument("--m", type=int, nargs="+", default=[64, 15857])
    parser.add_argument("--time", nargs=2, metavar=("SRC", "LABEL"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time:
        time_tree(Path(args.time[0]), args.time[1], args.B, args.m)
        return

    trees = [(name, None) for name in args.variants]
    if args.parent:
        trees.insert(0, ("parent", args.parent.resolve()))
    run_trees("spmv", Path(__file__).resolve(), "block_spmv", trees,
              lambda name: variant_tree("spmv_variants", name, "block_spmv", VARIANTS[name]),
              ["--B", *map(str, args.B), "--m", *map(str, args.m)])


if __name__ == "__main__":
    main()
