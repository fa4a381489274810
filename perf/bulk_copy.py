#!/usr/bin/env python3
"""One CTA's bulk-copy rate on the card, at the streamed megakernel's
row-chunk sizes.

    python3 perf/bulk_copy.py

The streamed megakernel in row chunks (B >= 170) moves each level's tiles
through one CTA's two stages of ``rows`` padded tile rows, so a level whose
row is solved by one CTA cannot take less than its bytes over one CTA's
copy rate. ``perf/bulk_copy.cu`` streams chunks of ``rows (B + 1)`` floats
(``kernels/superstep.py::streamed_shape``) through two stages, one chunk
ahead, as the kernel does, with no arithmetic; the time per chunk is the
difference of two launches (64 and 64 + 512 chunks, CUDA events, the least
of 5) over the 512 extra chunks. From device memory (a 1 GiB span walked
forward, larger than the 50 MB L2) and from L2 (an 8 MiB span). Prints the
card line and, per B, the chunk's bytes, µs per chunk and bytes per µs.
``chip_smoke.py`` phase 14 logs the same. Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().with_suffix(".cu")
LIBRARY = ROOT / "build" / "bulk_copy" / "bulk_copy.so"
CHUNKS = (64, 64 + 512)
SPANS = {"device memory": 1 << 28, "L2": 1 << 21}  # floats: 1 GiB, 8 MiB


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
    lib.repro_bulk_copy_f32.argtypes = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p)
    lib.repro_bulk_copy_f32.restype = ctypes.c_int
    return lib


def rates(lib: ctypes.CDLL, B: int) -> dict:
    """``{span name: (chunk bytes, µs per chunk, bytes per µs)}`` for the
    row chunks of block size ``B`` on one CTA of the kernel's warps."""
    import torch

    from repro_torch.kernels import superstep

    warps, _, rows = superstep.streamed_shape(B, 1)
    if rows >= B:
        raise ValueError(f"B={B} copies whole tiles, not row chunks")
    chunk = rows * (B + 1)
    out = torch.empty(32 * warps, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for name, span in SPANS.items():
        src = torch.ones(span, device="cuda")

        def run(n: int) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = lib.repro_bulk_copy_f32(src.data_ptr(), span, chunk, n, 32 * warps,
                                          out.data_ptr(), stream)
            end.record()
            end.synchronize()
            if err != 0:
                raise RuntimeError(f"bulk_copy_kernel launch failed: CUDA error {err}")
            return start.elapsed_time(end)

        run(CHUNKS[0])  # warm-up
        short, long = (min(run(n) for _ in range(5)) for n in CHUNKS)
        if float(out[0]) != CHUNKS[1]:
            raise RuntimeError(f"bulk_copy_kernel read {float(out[0])}, not {CHUNKS[1]} ones")
        us = 1e3 * (long - short) / (CHUNKS[1] - CHUNKS[0])
        result[name] = (4 * chunk, us, 4 * chunk / us)
        del src
    return result


def format_rates(B: int, r: dict) -> str:
    return f"B={B}: " + "; ".join(f"{name} {b} B a chunk, {us:.3f} us, {rate:.0f} B/us"
                                  for name, (b, us, rate) in r.items())


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(f"[bulk_copy] card: {card.stdout.strip() or 'nvidia-smi failed'}", flush=True)
    lib = load(start_build())
    for B in (176, 256):
        print("[bulk_copy] " + format_rates(B, rates(lib, B)), flush=True)


if __name__ == "__main__":
    main()
