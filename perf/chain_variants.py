#!/usr/bin/env python3
"""What each step of the megakernels' per-column chain costs on the card.

    python3 perf/chain_variants.py [--backend fused fused_streamed] [--side 1024]
                                   [--block-size 32] [--variants base ...]

Runs ``perf/profile_solve.py``'s megakernel split (whole; without tile
products; without solves) for ``csrc/superstep.cu`` as it is and for
variants of it, each an edit of a copy of the sources under
``build/chain_variants/<variant>/`` (the checkout is not touched; an edit
applies wherever its text occurs):

* ``base``: the kernel as it is;
* ``relaxed``: a row's ready flag published with ``st.relaxed.gpu``
  instead of ``st.release.gpu`` (no ordering of the row's ``x`` before its
  flag);
* ``nodiv``: the column's IEEE division ``__fdiv_rn(r, lii)`` replaced by a
  multiply;
* ``noshfl``: ``x_j`` not broadcast by ``__shfl_sync`` (each lane divides
  its own ``r``);
* ``notile`` (the row-chunked CTA path, B >= 170): the tile-product FMAs
  left to dead code, so a pulled tile costs its copies, its sources and
  the CTA's barriers;
* ``nogather`` (the same): warp 0 does not wait for the sources nor read
  them (no row waits for another: the levels run side by side);
* ``gridall`` (the same): every CTA that fits, in place of one for each
  work item of the widest level;
* ``stages3``, ``stages4`` (the same): a ring of 3 or 4 stages in place of
  ``CHUNK_STAGES`` (kernel and host rule edited alike; ``rows`` follows);
* ``uneven`` (the same): chunks of the most rows that fit, the last one
  short, in place of the evened-out ones.

The timing variants (``relaxed`` to ``nogather``) compute wrong values by
design; only their time is read, and the difference from ``base`` is what
that step adds. The shape variants (``gridall`` on) compute the same bits.
Prints the card line and, per variant and backend, the split line. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = Path("src/repro_torch/kernels/csrc/superstep.cu")
HOST = Path("src/repro_torch/kernels/superstep.py")


def _stages(k: int) -> list:
    """The row-chunked ring at ``k`` stages, in the kernel and in the host's
    shape rule (which sizes ``rows`` for it)."""
    return [(KERNEL, "constexpr int kChunkStages = 2;", f"constexpr int kChunkStages = {k};"),
            (HOST, "CHUNK_STAGES = 2  #", f"CHUNK_STAGES = {k}  #")]


VARIANTS = {
    "base": [],
    "relaxed": [(KERNEL, "st.release.gpu.global.b32", "st.relaxed.gpu.global.b32")],
    "nodiv": [(KERNEL, "__fdiv_rn(r, lii)", "(r * lii)")],
    "noshfl": [(KERNEL, "__shfl_sync(0xffffffffu, __fdiv_rn(r, lii), o)", "__fdiv_rn(r, lii)")],
    "notile": [(KERNEL, "  s[i0 + t] = s[i0 + t] + q;", "  s[i0 + t] = s[i0 + t] + ti[0];")],
    "nogather": [(KERNEL, "if (t < kWarp) gather_sources(a, pg, n, c, xcs, t);", "")],
    "gridall": [(KERNEL, "  const int need = (max_items * a.R + per_cta - 1) / per_cta;",
                 "  const int need = per_cta == 1 ? resident : (max_items * a.R + warps - 1) / warps;")],
    "stages3": _stages(3),
    "stages4": _stages(4),
    "uneven": [(HOST, "    per_chunk = -(-B // -(-B // most))", "    per_chunk = most")],
}


def variant_tree(name: str) -> Path:
    """A copy of ``src/`` and ``perf/`` with the variant's edits applied."""
    out = ROOT / "build" / "chain_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ignore = shutil.ignore_patterns("__pycache__")
    for sub in ("src", "perf"):
        shutil.copytree(ROOT / sub, out / sub, ignore=ignore)
    for path, old, new in VARIANTS[name]:
        src = (out / path).read_text()
        if old not in src:
            sys.exit(f"chain_variants.py: {name}: no {old!r} in {path}")
        (out / path).write_text(src.replace(old, new))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--backend", nargs="+", default=["fused", "fused_streamed"],
                        choices=("fused", "fused_streamed"))
    parser.add_argument("--side", type=int, default=1024)
    parser.add_argument("--block-size", type=int, default=32)
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    args = parser.parse_args()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    print(f"[variants] card: {card.stdout.strip() or 'nvidia-smi failed'}", flush=True)
    for name in args.variants:
        tree = variant_tree(name)
        for backend in args.backend:
            run = subprocess.run([sys.executable, "perf/profile_solve.py", "--backend",
                                  backend, "--side", str(args.side), "--block-size",
                                  str(args.block_size)], cwd=tree,
                                 capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                sys.exit(f"chain_variants.py: {name} {backend} failed:\n{run.stderr[-4000:]}")
            split = [ln for ln in run.stdout.splitlines() if "megakernel split" in ln]
            print(f"[variants] {name} {backend}: {split[0] if split else 'no split line'}",
                  flush=True)


if __name__ == "__main__":
    main()
