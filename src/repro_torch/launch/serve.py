"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Batched prefill + greedy decode of the reduced config (as the reference's
``repro.launch.serve``), with random parameters and prompts from a seed, on
the card unless ``--device cpu``. Prints the tokens' shape and the decode
rate; exit status 0. ``run(..., mesh=)`` serves on a ``DeviceMesh`` (every
rank of its process group calls it): the steps place parameters, cache and
batches by the sharding rules, and the tokens come back whole on every
rank. ``mesh=None`` runs on one device with no mesh.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.device import resolve_device
from repro_torch.distributed.constraints import whole
from repro_torch.distributed.meshutil import mesh_device
from repro_torch.models import init_cache, init_params
from repro_torch.serve.engine import make_decode_step, make_prefill_step


def run(arch: str, *, batch: int = 4, prompt_len: int = 32, new_tokens: int = 16,
        device=None, mesh=None, quiet: bool = False) -> torch.Tensor:
    """The (batch, new_tokens) greedy tokens, on the device; parameters and
    prompts drawn from seed 0."""
    cfg = get_reduced(arch)
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    cache = init_cache(cfg, batch, prompt_len + new_tokens, device=dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device=dev)
    examples = dict(mesh=mesh, example_params=params, example_cache=cache,
                    example_batch={"tokens": prompts})
    prefill = make_prefill_step(cfg, dev, **examples)
    decode = make_decode_step(cfg, dev, **examples)
    logits, cache = prefill(params, {"tokens": prompts}, cache)
    next_tok = torch.argmax(whole(logits)[:, -1, :cfg.vocab], dim=-1).to(torch.int32)
    out = [next_tok]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for t in range(new_tokens - 1):
        next_tok, cache = decode(params, {"tokens": next_tok[:, None]}, cache, prompt_len + t)
        next_tok = whole(next_tok)
        out.append(next_tok)
    toks = torch.stack(out, dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if not quiet and (mesh is None or torch.distributed.get_rank() == 0):
        print(f"[serve] {arch} on {dev}: {tuple(toks.shape)} tokens in {dt:.2f}s "
              f"({batch * (new_tokens - 1) / max(dt, 1e-9):.1f} tok/s)")
    return toks


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    run(args.arch, batch=args.batch, prompt_len=args.prompt_len,
        new_tokens=args.new_tokens, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
