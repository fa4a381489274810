#!/usr/bin/env python3
"""What each step of the megakernels' per-column chain costs on the card.

    python3 perf/chain_variants.py [--backend fused fused_streamed] [--side 1024]

Runs ``perf/profile_solve.py``'s megakernel split (whole; without tile
products; without solves) for ``csrc/superstep.cu`` as it is and for three
variants of it, each a one-line edit of a copy of the sources under
``build/chain_variants/<variant>/`` (the checkout is not touched):

* ``base``: the kernel as it is;
* ``relaxed``: a row's ready flag published with ``st.relaxed.gpu``
  instead of ``st.release.gpu`` (no ordering of the row's ``x`` before its
  flag);
* ``nodiv``: the column's IEEE division ``__fdiv_rn(r, lii)`` replaced by a
  multiply;
* ``noshfl``: ``x_j`` not broadcast by ``__shfl_sync`` (each lane divides
  its own ``r``).

Each variant computes wrong values by design; only its time is read, and
the difference from ``base`` is what that step adds to the chain. Prints
the card line and, per variant and backend, the split line. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = Path("src/repro_torch/kernels/csrc/superstep.cu")
VARIANTS = {
    "base": None,
    "relaxed": ("st.release.gpu.global.b32", "st.relaxed.gpu.global.b32"),
    "nodiv": ("__fdiv_rn(r, lii)", "(r * lii)"),
    "noshfl": ("__shfl_sync(0xffffffffu, __fdiv_rn(r, lii), o)", "__fdiv_rn(r, lii)"),
}


def variant_tree(name: str) -> Path:
    """A copy of ``src/`` and ``perf/`` with the variant's edit applied."""
    out = ROOT / "build" / "chain_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ignore = shutil.ignore_patterns("__pycache__")
    for sub in ("src", "perf"):
        shutil.copytree(ROOT / sub, out / sub, ignore=ignore)
    edit = VARIANTS[name]
    if edit is not None:
        src = (out / KERNEL).read_text()
        if src.count(edit[0]) != 1:
            sys.exit(f"chain_variants.py: {name}: expected one {edit[0]!r} in {KERNEL}, "
                     f"found {src.count(edit[0])}")
        (out / KERNEL).write_text(src.replace(edit[0], edit[1]))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--backend", nargs="+", default=["fused", "fused_streamed"],
                        choices=("fused", "fused_streamed"))
    parser.add_argument("--side", type=int, default=1024)
    args = parser.parse_args()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    print(f"[variants] card: {card.stdout.strip() or 'nvidia-smi failed'}", flush=True)
    for name in VARIANTS:
        tree = variant_tree(name)
        for backend in args.backend:
            run = subprocess.run([sys.executable, "perf/profile_solve.py", "--backend",
                                  backend, "--side", str(args.side)], cwd=tree,
                                 capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                sys.exit(f"chain_variants.py: {name} {backend} failed:\n{run.stderr[-4000:]}")
            split = [ln for ln in run.stdout.splitlines() if "megakernel split" in ln]
            print(f"[variants] {name} {backend}: {split[0] if split else 'no split line'}",
                  flush=True)


if __name__ == "__main__":
    main()
