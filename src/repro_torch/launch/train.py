"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The reference's fault-tolerance loop on one device (the card unless
``--device cpu``):

* resume from the last committed checkpoint (``CheckpointManager.latest_step``);
* checkpoint every ``--ckpt-every`` steps with an atomic commit, the
  manifest naming the arch and the device;
* a per-step wall-time budget sets the straggler flag in ``heartbeat.json``.

Parameters are drawn from ``torch.Generator(device).manual_seed(0)`` and
the data come from ``SyntheticLM``, a pure function of the step, so a run
that stops after a checkpoint and resumes continues the same losses. The
reduced config by default (``--full`` for the published one).

``run(..., mesh=)`` trains on a ``DeviceMesh`` (every rank of its process
group calls it): the step places parameters, moments and batches by the
sharding rules and the model's ``constrain`` calls apply. A checkpoint on a
mesh is gathered whole and written by rank 0; a restore reads it whole and
the step re-places it. ``--production-mesh`` runs on the 16 x 16
production mesh, which needs a started default process group of 256 ranks
(``torch.distributed.run``); without one it stops with ``meshutil``'s
error. ``mesh=None`` runs on one device with no mesh.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.constraints import whole
from repro_torch.distributed.meshutil import mesh_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_params, param_count
from repro_torch.models.model import tree_map
from repro_torch.train.optim import adamw_init
from repro_torch.train.step import make_train_step


def run(
    arch: str, *, steps: int = 20, reduced: bool = True, global_batch: int = 8,
    seq_len: int = 64, ckpt_dir: str | None = None, ckpt_every: int = 10,
    microbatches: int = 1, step_budget_s: float = 0.0, device=None, mesh=None,
    quiet: bool = False, peak_lr: float = 3e-4,
) -> list[float]:
    """The losses of the steps this call ran (from the resumed step on)."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw_init(params)
    data = SyntheticLM(cfg, global_batch, seq_len)
    step_fn = make_train_step(cfg, dev, mesh=mesh, microbatches=microbatches, peak_lr=peak_lr,
                              example_params=params, example_opt=opt,
                              example_batch=data.batch(0), donate=True)
    writer = mesh is None or dist.get_rank() == 0

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None and (last := mgr.latest_step()) is not None:
        params, opt, manifest = mgr.restore(last, params, opt, device=dev)
        start = manifest["step"] + 1
        if not quiet:
            print(f"[train] resumed from step {last}")

    if not quiet and writer:
        where = dev if mesh is None else f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
        print(f"[train] {cfg.name}: {param_count(params):,} params on {where}")
    hb_path = os.path.join(ckpt_dir, "heartbeat.json") if ckpt_dir else None
    losses = []
    for step in range(start, steps):
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, data.batch(step), step)
        loss = float(whole(metrics["loss"]))  # waits for the step
        dt = time.perf_counter() - t0
        losses.append(loss)
        straggler = bool(step_budget_s and dt > step_budget_s)
        if hb_path and writer:
            with open(hb_path, "w") as f:
                json.dump({"step": step, "loss": loss, "sec": dt, "straggler": straggler}, f)
        if not quiet and writer:
            print(f"[train] step {step:4d} loss {loss:.4f} ({dt * 1e3:.0f} ms)"
                  + (" STRAGGLER" if straggler else ""))
        if mgr is not None and (step + 1) % ckpt_every == 0:
            whole_p, whole_o = tree_map(whole, params), tree_map(whole, opt)
            if writer:
                mgr.save(step, whole_p, whole_o, {"arch": arch, "device": str(dev)})
            if mesh is not None:
                dist.barrier()
    return losses


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--full", action="store_true", help="the full published config")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the host)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16 x 16 mesh; needs a default process group of 256 ranks")
    args = ap.parse_args(argv)
    mesh = None
    if args.production_mesh:
        mesh = make_production_mesh(device_type=resolve_device(args.device).type)
    run(args.arch, steps=args.steps, reduced=not args.full, global_batch=args.global_batch,
        seq_len=args.seq_len, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        microbatches=args.microbatches, device=args.device, mesh=mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
