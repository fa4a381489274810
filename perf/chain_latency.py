#!/usr/bin/env python3
"""The dependency-chain floor of the row-sweep kernels, measured on the card.

    python3 perf/chain_latency.py

A forward substitution of B rows is a chain: x[i] needs x[i-1] through at
least one IEEE division and one FMA. ``perf/chain_latency.cu`` runs that
pair n times in a row on one warp; the time per step is the difference of
two launches (n = 1024 and 1024 + 65536 steps, CUDA events, the least of
5) over the 65536 extra steps, and B times it is the least time of a
B-row solve (``chain_bound_ms``), however wide the batch. ``chip_smoke.py``
prints it beside each row-sweep kernel's bytes bound. Prints the card line,
the step's ns and the floor at B = 16, 32 and 64. Needs a CUDA device and
``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().with_suffix(".cu")
LIBRARY = ROOT / "build" / "chain_latency" / "chain_latency.so"
STEPS = (1024, 1024 + 65536)


def start_build() -> subprocess.Popen:
    """Start ``nvcc`` on the microbenchmark (the kernels' flags), so a caller
    can build the kernels meanwhile; :func:`load` waits for it."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import extension

    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([extension.nvcc(), *extension.NVCC_FLAGS, "-o", str(LIBRARY),
                             str(SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def load(build: subprocess.Popen) -> ctypes.CDLL:
    log, _ = build.communicate()
    if build.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{log}")
    lib = ctypes.CDLL(str(LIBRARY))
    lib.repro_chain_f32.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p)
    lib.repro_chain_f32.restype = ctypes.c_int
    return lib


def step_ms(lib: ctypes.CDLL) -> float:
    """ms of one dependent division and FMA on this card."""
    import torch

    inp = torch.tensor([1.0, 2.0, -1.0, 1.5], device="cuda")
    out = torch.empty(32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(n: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.repro_chain_f32(inp.data_ptr(), out.data_ptr(), n, stream)
        end.record()
        end.synchronize()
        if err != 0:
            raise RuntimeError(f"chain_kernel launch failed: CUDA error {err}")
        return start.elapsed_time(end)

    run(STEPS[0])  # warm-up
    short, long = (min(run(n) for _ in range(5)) for n in STEPS)
    if abs(float(out[0]) - 1.0) > 1e-6:
        raise RuntimeError(f"chain_kernel left r = {float(out[0])}, not its fixed point 1")
    return (long - short) / (STEPS[1] - STEPS[0])


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(f"[chain] card: {card.stdout.strip() or 'nvidia-smi failed'}", flush=True)
    ms = step_ms(load(start_build()))
    print(f"[chain] one dependent __fdiv_rn + fmaf: {ms * 1e6:.3f} ns; chain_bound_ms "
          + " ".join(f"B={B}: {B * ms:.6f}" for B in (16, 32, 64)), flush=True)


if __name__ == "__main__":
    main()
