#!/usr/bin/env python3
"""Which collectives run on gloo with CUDA tensors: four ranks sharing one
card, each form under each group setting in a fresh group of its own
processes.

    python3 perf/gloo_dtensor_probe.py [--device cuda:0] [--forms all_reduce ...]
                                       [--settings gloo ...]

Forms: ``all_reduce``, ``all_gather`` (a list of tensors),
``all_gather_into_tensor``, ``mesh_all_gather`` (``dist.all_gather`` over a
2 x 2 ``DeviceMesh``'s per-dim groups, reassembling a tensor placed by
``repro_torch.distributed.shard_tree``), ``full_tensor`` (DTensor's own
gather of the same placement, through functional collectives), and the
three DTensor collectives a mesh step issues: ``constrain`` (a
``Shard -> Replicate`` redistribution), ``row_parallel`` (a row-parallel
product's ``Partial -> Replicate``) and ``gnorm`` (a global norm over a
sharded tensor).

Settings (how the group is made): ``gloo`` (``init_process_group("gloo")``),
``gloo_device_id`` (the same, bound to the card with ``device_id=``), and
``staged`` (``repro_torch.distributed.staged``: a Python backend that runs
every collective through gloo on host copies). Each rank checks its result
against the tensor every rank drew; a form passes when all four processes
exit 0. Prints one line per (setting, form): the processes' exit codes
(-11 is a segmentation fault) and its wall seconds, spawn included.
"""
from __future__ import annotations

import argparse
import datetime
import faulthandler
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORMS = ("all_reduce", "all_gather", "all_gather_into_tensor", "mesh_all_gather", "full_tensor",
         "constrain", "row_parallel", "gnorm")
DTENSOR_FORMS = ("full_tensor", "constrain", "row_parallel", "gnorm")
SETTINGS = ("gloo", "gloo_device_id", "staged")
RANKS = 4


def _rank(setting: str, form: str, rank: int, rdv: str, device: str) -> None:
    faulthandler.enable()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import make_mesh, shard_tree, staged

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    kw = {}
    backend = "gloo"
    if setting == "gloo_device_id":
        kw["device_id"] = dev
    elif setting == "staged":
        staged.register()
        backend = staged.BACKEND
    dist.init_process_group(backend, init_method=f"file://{rdv}", rank=rank, world_size=RANKS,
                            timeout=datetime.timedelta(seconds=120), **kw)
    x = torch.randn((1024, 256), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    part = x.chunk(RANKS)[rank].contiguous()
    if form == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        ok = torch.equal(y, x * RANKS)
    elif form == "all_gather":
        parts = [torch.empty_like(part) for _ in range(RANKS)]
        dist.all_gather(parts, part)
        ok = torch.equal(torch.cat(parts), x)
    elif form == "all_gather_into_tensor":
        y = torch.empty_like(x)
        dist.all_gather_into_tensor(y, part)
        ok = torch.equal(y, x)
    else:
        mesh = make_mesh((2, 2), ("data", "model"), dev.type)
        dt = shard_tree(x, ("model", "data"), mesh)
        whole = [Replicate(), Replicate()]
        if form == "full_tensor":
            y = dt.full_tensor()
        elif form == "constrain":
            y = dt.redistribute(mesh, whole).to_local()
        elif form == "row_parallel":
            w = torch.randn((256, 64), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
            xs, ws = shard_tree(x, (None, "model"), mesh), shard_tree(w, ("model", None), mesh)
            y = (xs @ ws).redistribute(mesh, whole).to_local()
            x = x @ w
        elif form == "gnorm":
            y = torch.sqrt(torch.sum(torch.square(dt))).redistribute(mesh, whole).to_local()
            x = torch.sqrt(torch.sum(torch.square(x)))
        else:
            y = dt.to_local()
            for i in reversed(range(mesh.ndim)):
                if isinstance(dt.placements[i], Shard):
                    parts = [torch.empty_like(y) for _ in range(mesh.size(i))]
                    dist.all_gather(parts, y.contiguous(), group=mesh.get_group(i))
                    y = torch.cat(parts, dim=dt.placements[i].dim)
        ok = (torch.allclose(y, x, rtol=1e-5, atol=1e-4) if form in ("row_parallel", "gnorm")
              else torch.equal(y, x))
    dist.destroy_process_group()
    sys.exit(0 if ok else 1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--forms", nargs="+", default=list(FORMS), choices=FORMS)
    ap.add_argument("--settings", nargs="+", default=list(SETTINGS), choices=SETTINGS)
    args = ap.parse_args()
    if args.device.startswith("cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    spawn = multiprocessing.get_context("spawn")
    # the plain collectives under the first setting only; DTensor's under each
    runs = [(s, f) for s in args.settings for f in args.forms
            if f in DTENSOR_FORMS or s == args.settings[0]]
    for setting, form in runs:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            procs = [spawn.Process(target=_rank,
                                   args=(setting, form, r, f"{tmp}/rdv", args.device))
                     for r in range(RANKS)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(180)
            for p in procs:
                if p.is_alive():
                    p.kill()
            codes = [p.exitcode for p in procs]
            print(f"[probe] {form} on {setting}, {RANKS} ranks on {args.device}: "
                  f"exit codes {codes} "
                  f"({'ok' if codes == [0] * RANKS else 'FAILED'}), "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
