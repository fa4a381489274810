#!/usr/bin/env python3
"""The multi-device executors' exchange alone: ``all_reduce`` of a carry
over a gloo group of ranks sharing one card, ms per call.

    python3 perf/gloo_exchange.py [--ranks 2] [--rows 32769] [--widths 32 256] [--calls 50]
                                  [--device cuda:0]

Starts ``--ranks`` processes on ``cuda:0`` (one gloo group, loopback
rendezvous through a file), and on each a float32 ``(rows, width)`` CUDA
tensor per width, the shape of ``delta`` for ``rows`` block rows of
``width = B x R`` floats (``32769 x 32``: the n = 1,048,576 factor at
B = 32, a vector; ``x 256``: an (n, 8) panel; ``--rows 1``: one zerocopy
packed exchange of one boundary row; ``--device cpu``: the same on host
tensors, for the gloo round trip without the card). Times ``--calls`` calls of
:func:`repro_torch.core.comm.all_reduce_sum_` back to back after a barrier,
the host clock around them with the stream synchronised at both ends
(gloo stages CUDA tensors through host memory, so the card's copies and the
host's transfer are both in the time). Checks the sum, prints the card line
and one JSON line per width from rank 0. This measures no interconnect
between cards: it is what D ranks on one card pay per superstep.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _rank(rank: int, world: int, path: str, args, out) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.core import comm

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    group = dist.group.WORLD
    on_card = torch.device(args.device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rows = []
    for width in args.widths:
        t = torch.full((args.rows, width), float(rank + 1), device=args.device)
        comm.all_reduce_sum_(t, group)  # the first call sets up the pairs
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            t.fill_(float(rank + 1))
            comm.all_reduce_sum_(t, group)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / args.calls
        want = world * (world + 1) / 2
        if not bool((t == want).all()):
            raise RuntimeError(f"all_reduce gave {t.flatten()[:4].tolist()}, not {want}")
        rows.append({"ranks": world, "device": args.device, "shape": [args.rows, width],
                     "mbytes": args.rows * width * 4 / 1e6, "ms_per_all_reduce": ms,
                     "calls": args.calls})
    if rank == 0:
        out.put(rows)
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--rows", type=int, default=32769)
    ap.add_argument("--widths", type=int, nargs="+", default=[32, 256])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--device", default="cuda:0",
                    help="where the ranks' tensors live: cuda:0 (all on one card) or cpu")
    args = ap.parse_args()
    import multiprocessing

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    spawn = multiprocessing.get_context("spawn")
    out = spawn.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [spawn.Process(target=_rank, args=(r, args.ranks, str(Path(tmp) / "rdv"),
                                                   args, out)) for r in range(args.ranks)]
        for p in procs:
            p.start()
        rows = out.get(timeout=600)
        for p in procs:
            p.join(120)
            if p.exitcode is None:
                p.kill()
        if any(p.exitcode != 0 for p in procs):
            sys.exit(f"ranks exited {[p.exitcode for p in procs]}")
    print(card)
    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
