#!/usr/bin/env python3
"""Where one LM train step's time goes on the card.

    python3 perf/profile_train.py [--arch llama3.2-1b] [--batch 4] [--seq 2048]
                                  [--reps 3]

Builds the published config of ``--arch`` in its own dtypes (bfloat16 for
llama3.2-1b), random parameters from seed 0, and times with CUDA events
(median of ``--reps`` after one warm-up call each):

* the whole ``make_train_step`` step;
* ``loss_fn`` forward alone (no grad);
* ``value_and_grad`` with ``remat`` on and off;
* ``adamw_update`` alone on those gradients;
* one layer's attention at the step's shapes, forward and forward plus
  backward: the port's ``_flash`` (differentiable: each key chunk
  recomputed), the plain path (float32 scores, softmax), and
  ``torch.nn.functional.scaled_dot_product_attention`` (the library's
  fused kernel, for scale only; the port does not call it);
* ``cross_entropy`` forward plus backward on the step's logits.

Then one whole step under ``torch.profiler``: its kernels' time, their
count, the cuBLAS GEMMs' share, the kernels that took the most, and the
PyTorch operators (forward and backward) ranked by the device time of the
kernels they launched themselves. Prints the card's ``nvidia-smi`` name and
power limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

GEMM = r"(?i)gemm|gemv|xmma|cutlass|cublas|sm90_|nvjet"  # cuBLAS's matmul kernels


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--arch", default="llama3.2-1b")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import attention, init_params
    from repro_torch.models.layers import cross_entropy, softcap
    from repro_torch.models.model import loss_fn
    from repro_torch.train import adamw_init, adamw_update, make_train_step
    from repro_torch.train.step import value_and_grad

    if not torch.cuda.is_available():
        sys.exit("profile_train.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    cfg = get_config(args.arch)
    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw_init(params)
    B, S = args.batch, args.seq
    data = SyntheticLM(cfg, B, S)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in data.batch(0).items()}

    def timed(fn) -> float:
        """Median ms of ``fn()`` over ``--reps`` calls after one warm-up,
        each between two CUDA events on a synchronized stream."""
        fn()
        times = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    rows = {}
    step = make_train_step(cfg, dev)
    rows["train step (make_train_step)"] = timed(lambda: step(params, opt, batch, 200))
    with torch.no_grad():
        rows["loss_fn forward, no grad"] = timed(
            lambda: loss_fn(params, cfg, batch["tokens"], batch["labels"]))
    held = {}

    def grads(remat):
        held["loss"], held["grads"] = value_and_grad(cfg, params, batch, remat=remat)

    rows["value_and_grad, remat on"] = timed(lambda: grads(True))
    rows["value_and_grad, remat off"] = timed(lambda: grads(False))
    rows["adamw_update"] = timed(lambda: adamw_update(params, held["grads"], opt, lr=1e-6))
    del held["grads"]

    # one layer's attention at the step's shapes (K/V already repeated to H heads)
    H, hd = cfg.n_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = getattr(torch, cfg.dtype)
    q, k, v = (torch.randn((B, S, H, hd), generator=gen, device=dev).to(dt).requires_grad_()
               for _ in range(3))
    g_out = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dt)

    def plain(q, k, v):
        s = torch.einsum("bshd,bthd->bhst", q, k).float() * hd ** -0.5
        if cfg.softcap > 0:
            s = softcap(s, cfg.softcap)
        mask = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
        w = torch.softmax(torch.where(mask[None, None], s, attention.NEG), dim=-1).to(q.dtype)
        return torch.einsum("bhst,bthd->bshd", w, v)

    def flash(q, k, v):
        return attention._flash(q, k, v, cfg, causal=True, window=0, differentiable=True)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True).transpose(1, 2)

    for name, fn in (("_flash", flash), ("plain attention", plain), ("SDPA (library)", sdpa)):
        with torch.no_grad():
            rows[f"attention, one layer, {name}, forward"] = timed(lambda fn=fn: fn(q, k, v))
        rows[f"attention, one layer, {name}, forward + backward"] = timed(
            lambda fn=fn: torch.autograd.backward(fn(q, k, v), g_out))
    del q, k, v, g_out

    logits = torch.randn((B, S, cfg.padded_vocab), generator=gen, device=dev).to(dt)
    logits.requires_grad_()
    rows["cross_entropy, forward + backward"] = timed(
        lambda: cross_entropy(logits, batch["labels"], cfg.final_softcap,
                              valid_vocab=cfg.vocab).backward())
    del logits

    print(f"{args.arch} ({cfg.dtype}), batch {B}, S {S}; CUDA-event ms, median of {args.reps}:")
    for name, ms in rows.items():
        print(f"  {name:58s} {ms:10.3f}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch, 201)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    gemm = sum(e.self_device_time_total for e in kernels if re.search(GEMM, e.key)) / 1e3
    print(f"one step under torch.profiler: {busy:.3f} ms of kernels, "
          f"{sum(e.count for e in kernels)} kernels, cuBLAS GEMMs {gemm:.3f} ms "
          f"({gemm / busy:.1%})")
    for e in kernels[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms x{e.count:5d}  {e.key[:110]}")
    print("operators by the device time of the kernels they launched:")
    for e in ops[:20]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms x{e.count:5d}  {e.key[:110]}")


if __name__ == "__main__":
    main()
