#!/usr/bin/env python3
"""Device time of the TRSV and the panel TRSV (``csrc/block_trsv.cu``) for
designs of their B <= 32 kernels.

    python3 perf/trsv_variants.py [--parent DIR] [--variants base tiles4 ...]
                                  [--k 32 4096] [--B 16 32 64] [--P 4 8 16]

Times ``block_trsv``, ``block_trsv_panel`` (every P that divides B) and
``torch.linalg.solve_triangular`` at every (k, B): device ms per call,
``torch.profiler``'s ``key_averages()`` over 50 calls of the named kernel
alone (as ``chip_smoke.py`` reads them). The default k are the main path's
widest level (32 tiles) and a wide batch (4096). Each design is an edit of a
copy of ``src/`` under ``build/trsv_variants/<variant>/`` (the checkout is
not touched), built fresh:

* ``base``: the kernels as they are (one tile per CTA; the panel kernel
  loads its row and column entries straight from device memory, the row
  entries strided across lanes; P fixed at compile time for powers of
  two);
* ``tiles4``: four tiles (warps) per CTA, both kernels;
* ``staged``: the panel kernel stages the tile through shared memory
  (coalesced row loads, each store after its load) and reads its row and
  column entries from there;
* ``loadsfirst``: ``staged`` with every load issued first (into the
  registers, the column entries kept), then the stores;
* ``guarded``: the panel kernel takes P at run time for every P, behind
  guards that are the same on every lane;
* ``deferred``: the panel kernel adds row i's update term to u in row
  i + 1, after its butterfly, not right after the broadcast in row i;
* ``endupdate``: the panel kernel broadcasts the panel's P values of x
  after its last row (independent shuffles) and runs each lane's FMA chain
  of depth P there;
* ``lb16``: both kernels declare at least 16 CTAs per SM in
  ``__launch_bounds__`` (128 registers a thread allowed, not 64).

B > 32 runs ``trsv_rowsweep_kernel`` and ``trsv_panel_kernel`` in every
design. Before timing, each tree (the parent's first) is checked: at B <= 32
its TRSV against ``ref.rowsweep_bits_ref`` and its panel TRSV against
``ref.panel_bits_ref`` of this checkout, bit for bit; at every B its TRSV
against its TRSM of the same column, bit for bit, and its panel TRSV within
2e-5 of the plain version (``bits=ok`` or ``bits=DIFFER`` on its lines).
``--parent DIR`` also times the kernels of another checkout of the
repository (for example ``git archive`` of the parent commit unpacked into
``build/parent/``), built in its own ``build/``. Prints the card line, each
tree's registers and spills from ``ptxas``, and one line per tree and shape:
``[trsv] <tree> k=.. B=.. bits=.. trsv=.. panel_P<P>=.. lib=..``. Needs a
CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from variant_trees import device_ms, edits, oracles, run_trees, variant_tree

# this tree's kernels and the parent's (trsv_rowsweep_kernel, trsv_panel_kernel)
TRSV_RE = r"(?<![A-Za-z_])trsv_(?:rowsweep_)?kernel(?=[(<EI ]|$)"
PANEL_RE = r"(?<![A-Za-z_])trsv_panel_(?:sweep_)?kernel(?=[(<EI ]|$)"
LIBRARY_RE = r"(?i)gemm|gemv|trsm|trsv|xmma|cutlass|cublas|sm90_"  # as chip_smoke.py

# the tile staged through shared memory (rows kWarp + 1 floats apart, so
# neither the row nor the column reads conflict): each store waiting on its
# load (STAGED), or every load issued first into A, then the stores (LOADS_FIRST)
STAGED_LOAD = """\
__device__ __forceinline__ void load_panel(const float* __restrict__ Lt, int B, int P, int lane,
                                           float (&A)[kWarp], float& d) {
  __shared__ float S[kSweepTiles][kWarp * (kWarp + 1)];
  float* St = S[threadIdx.x / kWarp];
  constexpr int ld = kWarp + 1;
#pragma unroll
  for (int s = 0; s < kWarp; ++s)
    if (s < B && lane < B) St[s * ld + lane] = __ldg(Lt + s * B + lane);
  __syncwarp();
  const int b = lane - lane % P;
#pragma unroll
  for (int m = 0; m < kWarp; ++m) {
    const bool row = m < b, col = lane < m && m < b + P;
    A[m] = lane < B && (row || col) ? St[row ? lane * ld + m : m * ld + lane] : 0.f;
  }
  d = lane < B ? St[lane * ld + lane] : 1.f;
}
"""
LOADS_FIRST = """\
__device__ __forceinline__ void load_panel(const float* __restrict__ Lt, int B, int P, int lane,
                                           float (&A)[kWarp], float& d) {
  __shared__ float S[kSweepTiles][kWarp * (kWarp + 1)];
  float* St = S[threadIdx.x / kWarp];
  constexpr int ld = kWarp + 1;
#pragma unroll
  for (int s = 0; s < kWarp; ++s) A[s] = s < B && lane < B ? __ldg(Lt + s * B + lane) : 0.f;
#pragma unroll
  for (int s = 0; s < kWarp; ++s) St[s * ld + lane] = A[s];
  __syncwarp();
  const int b = lane - lane % P;
#pragma unroll
  for (int m = 0; m < kWarp; ++m)
    A[m] = lane < B && m < b ? St[lane * ld + m] : lane < m && m < b + P ? A[m] : 0.f;
  d = lane < B ? St[lane * ld + lane] : 1.f;
}
"""


def replace_load(new: str):
    """``load_panel`` replaced by ``new``."""
    def edit(src: str) -> str:
        start = src.index("__device__ __forceinline__ void load_panel(")
        end = src.index("\n}\n", start) + 3
        return src[:start] + new + src[end:]
    return edit


EAGER = """\
    u = __fmaf_rn(A[i], __shfl_sync(kFull, q, i), u);
    if (i == base + P - 1) {  // the panel's last row: the rows below take its update
"""
DEFERRED = """\
    xb = __shfl_sync(kFull, q, i);
    if (i == base + P - 1) {  // the panel's last row: the rows below take its update
      u = __fmaf_rn(A[i], xb, u);
"""
DEFERRED_TERM = ("      q = __fdiv_rn(r - p, d);\n",
                 "      u = __fmaf_rn(A[i > 0 ? i - 1 : 0], xb, u);  // row i - 1's term\n"
                 "      q = __fdiv_rn(r - p, d);\n")
DEFERRED_X = ("  float x = 0.f, u = 0.f;\n", "  float x = 0.f, u = 0.f, xb = 0.f;\n")
BATCHED_END = """    if (i == base + P - 1) {  // the panel's last row: the rows below take its update
#pragma unroll
      for (int c = 0; c < kWarp; ++c)
        if (base <= c && c <= i) u = __fmaf_rn(A[c], __shfl_sync(kFull, x, c), u);
"""
BOUNDS = "__global__ void __launch_bounds__(kSweepTiles * kWarp)\n    {}("
VARIANTS = {
    "base": None,
    "tiles4": edits(("constexpr int kSweepTiles = 1;", "constexpr int kSweepTiles = 4;")),
    "staged": replace_load(STAGED_LOAD),
    "loadsfirst": replace_load(LOADS_FIRST),
    "guarded": edits(("const int P = kP > 0 ? kP : panel;", "const int P = panel;")),
    "deferred": edits((EAGER, DEFERRED), DEFERRED_TERM, DEFERRED_X),
    "endupdate": edits((EAGER, BATCHED_END)),
    "lb16": edits(*((BOUNDS.format(n), BOUNDS.format(n).replace("kWarp)", "kWarp, 16)"))
                    for n in ("trsv_kernel", "trsv_panel_sweep_kernel"))),
}


def time_tree(src: Path, label: str, ks: list[int], Bs: list[int], Ps: list[int]) -> None:
    """Child process: check and time one tree's TRSV and panel TRSV."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.kernels import block_trsv as k

    ref = oracles()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kk in ks:
        for B in Bs:
            L = torch.tril(torch.rand(kk, B, B, device="cuda", generator=gen) * 2 - 1, -1) / B
            L += 2 * torch.eye(B, device="cuda")
            r = torch.rand(kk, B, device="cuda", generator=gen) * 2 - 1
            x = k.block_trsv(L, r)
            bits = torch.equal(x, k.block_trsm(L, r[..., None].contiguous())[..., 0])
            if B <= ref.WARP:
                bits = bits and torch.equal(x.cpu(), ref.rowsweep_bits_ref(L.cpu(), r.cpu()))
            times = {"trsv": device_ms(lambda: k.block_trsv(L, r), TRSV_RE)}
            for P in (P for P in Ps if B % P == 0):
                xp = k.block_trsv_panel(L, r, P)
                want = ref.block_trsv_panel_ref(L, r, P)
                bits = bits and torch.allclose(xp, want, rtol=2e-5, atol=2e-5)
                if B <= ref.WARP:
                    bits = bits and torch.equal(xp.cpu(), ref.panel_bits_ref(L.cpu(), r.cpu(), P))
                times[f"panel_P{P}"] = device_ms(lambda: k.block_trsv_panel(L, r, P), PANEL_RE)
            times["lib"] = device_ms(
                lambda: torch.linalg.solve_triangular(L, r[..., None], upper=False), LIBRARY_RE)
            print(f"[trsv] {label} k={kk} B={B} bits={'ok' if bits else 'DIFFER'} "
                  + " ".join(f"{n}={t}" for n, t in times.items()), flush=True)
            del L
            torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    parser.add_argument("--parent", type=Path, help="another checkout, timed as 'parent'")
    parser.add_argument("--k", type=int, nargs="+", default=[32, 4096])
    parser.add_argument("--B", type=int, nargs="+", default=[16, 32, 64])
    parser.add_argument("--P", type=int, nargs="+", default=[4, 8, 16])
    parser.add_argument("--time", nargs=2, metavar=("SRC", "LABEL"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time:
        time_tree(Path(args.time[0]), args.time[1], args.k, args.B, args.P)
        return

    trees = [(name, None) for name in args.variants]
    if args.parent:
        trees.insert(0, ("parent", args.parent.resolve()))
    run_trees("trsv", Path(__file__).resolve(), "block_trsv", trees,
              lambda name: variant_tree("trsv_variants", name, "block_trsv", VARIANTS[name]),
              ["--k", *map(str, args.k), "--B", *map(str, args.B), "--P", *map(str, args.P)])


if __name__ == "__main__":
    main()
