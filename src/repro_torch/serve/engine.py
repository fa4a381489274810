"""Serving steps: batched prefill and single-token decode with a KV cache.

``make_prefill_step(cfg, device=...)`` and ``make_decode_step(cfg,
device=...)`` return steppers that move their inputs to the device (a
no-op for tensors already there), run ``models.forward`` under
``torch.no_grad``, and record the span ``serve.prefill`` / ``serve.decode``
and the counter ``serve.prefills`` / ``serve.decodes`` in the port's
telemetry. The cache is updated in place and returned. Decode samples
greedily after masking the padded vocab, so a step is deterministic; the
launcher wraps these into a request loop.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import vocab_pad_mask
from repro_torch.models.model import forward, tree_map
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer


def _on(dev: torch.device):
    return lambda tree: tree_map(lambda t: t.to(dev), tree)


def make_prefill_step(cfg: ModelConfig, device=None):
    """``prefill(params, batch, cache) -> (logits (B, 1, V), cache)``: the
    prompt in ``batch["tokens"]`` (or ``"embeds"``, plus ``"enc_out"`` for
    an encoder-decoder) from position 0; logits of the last position."""
    on = _on(resolve_device(device))

    def prefill(params, batch, cache):
        with get_tracer().span("serve.prefill"), torch.no_grad():
            get_registry().counter("serve.prefills").inc()
            batch = on(batch)
            return forward(on(params), cfg, batch.get("tokens"), embeds=batch.get("embeds"),
                           cache=on(cache), pos_offset=0, enc_out=batch.get("enc_out"),
                           last_only=True)

    return prefill


def make_decode_step(cfg: ModelConfig, device=None):
    """``decode(params, batch, cache, pos) -> (next_tok (B,) int32, cache)``:
    one token for every sequence in the batch at position ``pos`` (a host
    int), greedy argmax sampling over the valid vocab."""
    on = _on(resolve_device(device))

    def decode(params, batch, cache, pos: int):
        with get_tracer().span("serve.decode", pos=int(pos)), torch.no_grad():
            get_registry().counter("serve.decodes").inc()
            batch = on(batch)
            logits, cache = forward(on(params), cfg, batch.get("tokens"),
                                    embeds=batch.get("embeds"), cache=on(cache),
                                    pos_offset=int(pos))
            logits = vocab_pad_mask(logits[:, -1].float(), cfg.vocab)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return decode
