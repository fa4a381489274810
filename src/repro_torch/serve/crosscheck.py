"""What the serving path computes for one input, on a chosen device.

``serve_outputs`` runs the encoder (encoder-decoder configs), a full
forward, ``loss_fn``, and the engine's prefill followed by greedy decode
steps, and returns the results on the host. Run once on the card and once on
the CPU with the same parameters and batch, the two can be held to each
other (``chip_smoke.py`` phase 15, ``tests/test_torch_lm_cuda.py``).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import vocab_pad_mask
from repro_torch.models.model import encode, forward, init_cache, loss_fn, tree_map
from repro_torch.serve.engine import make_decode_step, make_prefill_step


def serve_outputs(cfg: ModelConfig, params: dict, batch: dict, *, device=None,
                  steps: int = 16) -> dict:
    """``batch`` as ``SyntheticLM.batch`` makes it (numpy arrays or tensors).
    Returns CPU tensors: ``logits`` (B, S, V) of the full forward,
    ``encode`` (or None), ``loss``, ``prefill`` (B, 1, V), the prefill's
    greedy token and ``steps`` decoded after it as ``tokens`` (B, steps + 1)."""
    dev = resolve_device(device)
    p = tree_map(lambda t: t.to(dev), params)
    b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    out = {}
    with torch.no_grad():
        enc = encode(p, cfg, b["enc_embeds"]) if "enc_embeds" in b else None
        out["encode"] = enc
        out["logits"], _ = forward(p, cfg, b.get("tokens"), embeds=b.get("embeds"),
                                   enc_out=enc)
        out["loss"] = loss_fn(p, cfg, b.get("tokens"), b["labels"], embeds=b.get("embeds"),
                              enc_embeds=b.get("enc_embeds"))
    B, S = b["labels"].shape
    cache = init_cache(cfg, B, S + steps, device=dev)
    prompt = {k: b[k] for k in ("tokens", "embeds") if k in b}
    logits, cache = make_prefill_step(cfg, device=dev)(p, dict(prompt, enc_out=enc), cache)
    out["prefill"] = logits
    tok = torch.argmax(vocab_pad_mask(logits[:, -1].float(), cfg.vocab), dim=-1).to(torch.int32)
    toks = [tok]
    decode = make_decode_step(cfg, device=dev)
    for t in range(S, S + steps):
        tok, cache = decode(p, {"tokens": tok[:, None]}, cache, t)
        toks.append(tok)
    out["tokens"] = torch.stack(toks, dim=1)
    return {k: None if v is None else v.cpu() for k, v in out.items()}
