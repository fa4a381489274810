#!/usr/bin/env python3
"""The LM steps with no mesh, timed on two source trees in one call.

    python3 perf/lm_ab.py --tree parent=build/parent --tree change=. \
                          [--order parent,change,change,parent]

Each ``--tree NAME=DIR`` names a checkout whose ``DIR/src`` holds a
``repro_torch``. For each name in ``--order`` a fresh process imports that
tree's port and times llama3.2-1b at its published width in bfloat16,
random parameters from seed 0, exactly as ``chip_smoke.py`` phases 15b and
16c do:

* serving, batch 8, a 512-token prompt: one warm-up pass of a prefill and
  2 decode steps, then a prefill (ms, host clock after a synchronize) and
  63 greedy decode steps (ms a step);
* the train step (``make_train_step``, ``remat`` on) at batch 4 x 2048:
  2 warm-up steps, then the median of 8 (each step's time ends when its
  loss reaches the host).

Prints the card's ``nvidia-smi`` name and power limit, one JSON line a run,
then a table of each tree's runs. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"
PROMPT, SERVE = 512, (8, 64)  # prompt tokens; batch, new tokens
TRAIN, STEPS = (4, 2048), (2, 8)  # batch, S; warm-up and timed steps


def child() -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.layers import vocab_pad_mask
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    from repro_torch.train import adamw_init, make_train_step

    cfg = get_config(ARCH)
    out = {}

    def greedy(logits):
        return torch.argmax(vocab_pad_mask(logits.float(), cfg.vocab), dim=-1).to(torch.int32)

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    B, new = SERVE
    prompt = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen, device="cuda")
    prefill, decode = make_prefill_step(cfg, device="cuda"), make_decode_step(cfg, device="cuda")

    def serve(n_new):
        cache = init_cache(cfg, B, PROMPT + new, device="cuda")
        t = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompt}, cache)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t
        tok = greedy(logits[:, -1])
        t = time.perf_counter()
        for i in range(n_new - 1):
            tok, cache = decode(params, {"tokens": tok[:, None]}, cache, PROMPT + i)
        torch.cuda.synchronize()
        return t_pre, (time.perf_counter() - t) / (n_new - 1)

    serve(3)
    t_pre, t_dec = serve(new)
    out.update(prefill_ms=1e3 * t_pre, decode_ms=1e3 * t_dec)
    del params, prefill, decode
    torch.cuda.empty_cache()

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    opt = adamw_init(params)
    data = SyntheticLM(cfg, *TRAIN)
    step = make_train_step(cfg, "cuda")
    warm, timed = STEPS
    times = []
    for i in range(warm + timed):
        t = time.perf_counter()
        params, opt, metrics = step(params, opt, data.batch(i), i)
        float(metrics["loss"])
        times.append(time.perf_counter() - t)
    out["train_ms"] = 1e3 * sorted(times[warm:])[timed // 2]
    out["train_times_ms"] = [1e3 * t for t in times]
    print(json.dumps(out), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", default=[], metavar="NAME=DIR")
    parser.add_argument("--order", help="comma-separated names (default: each tree once)")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child()
        return
    if not args.tree:
        parser.error("give at least one --tree NAME=DIR")
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    runs = []
    for name in order:
        src = str((ROOT / trees[name] / "src").resolve())
        env = dict(os.environ, PYTHONPATH=src)
        res = subprocess.run([sys.executable, __file__, "--child"],
                             env=env, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            sys.exit(f"{name}: exit {res.returncode}\n{res.stderr[-4000:]}")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        r["tree"] = name
        print(json.dumps(r), flush=True)
        runs.append(r)
    print(f"{'tree':<10} {'prefill ms':>12} {'decode ms':>12} {'train ms':>12}")
    for r in runs:
        print(f"{r['tree']:<10} {r['prefill_ms']:>12.3f} {r['decode_ms']:>12.4f} "
              f"{r['train_ms']:>12.3f}")


if __name__ == "__main__":
    main()
