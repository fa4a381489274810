"""Serving steps: batched prefill and single-token decode with a KV cache.

``make_prefill_step(cfg, device=...)`` and ``make_decode_step(cfg,
device=...)`` return steppers that move their inputs to the device (a
no-op for tensors already there), run ``models.forward`` under
``torch.no_grad``, and record the span ``serve.prefill`` / ``serve.decode``
and the counter ``serve.prefills`` / ``serve.decodes`` in the port's
telemetry. The cache is updated in place and returned. Decode samples
greedily after masking the padded vocab, so a step is deterministic; the
launcher wraps these into a request loop.

On a mesh (``mesh=`` with ``example_params``, ``example_cache`` and
``example_batch``), the steppers place their inputs on entry by the
sharding rules, as the reference's ``device_put`` does: parameters by
``param_specs`` (FSDP over the data axes if ``fsdp``), the cache by
``cache_specs`` (batch over the data axes, the KV sequence or SSM
channels over ``model``), the batch by ``batch_specs``. The forward runs
under ``set_mesh(mesh)``; the cache is updated in place and keeps its
placements; prefill's logits come back over the data axes on dim 0 and
decode's tokens placed as the batch. With a mesh and no ``example_*`` the
bare step runs under the caller's ambient mesh.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.distributed.constraints import local, spec_of
from repro_torch.distributed.meshutil import dp_axes, mesh_device, set_mesh
from repro_torch.distributed.sharding import batch_specs, cache_specs, param_specs, shard_tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import vocab_pad_mask
from repro_torch.models.model import forward, tree_map
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer


def _placer(device, mesh, example_params, example_cache, fsdp):
    """``(place(params, batch, cache), context)``: moves or places the
    inputs, and the context the forward runs in. A batch is placed by the
    batch rule on its own shape (the reference's ``example_batch`` gives the
    same specs)."""
    if mesh is None or example_params is None:
        dev = mesh_device(mesh) if mesh is not None else resolve_device(device)

        def on(tree):
            return tree_map(lambda t: t if isinstance(t, DTensor) else t.to(dev), tree)

        return lambda p, b, c: (on(p), on(b), on(c)), contextlib.nullcontext
    dev = mesh_device(mesh)
    dp = dp_axes(mesh)
    pspecs = param_specs(example_params, mesh, fsdp_axes=dp if fsdp else ())
    cspecs = cache_specs(example_cache, mesh, dp_axes=dp)

    def place(p, b, c):
        return (shard_tree(p, pspecs, mesh, dev),
                shard_tree(b, batch_specs(b, mesh, dp_axes=dp), mesh, dev),
                shard_tree(c, cspecs, mesh, dev))

    return place, lambda: set_mesh(mesh)


def make_prefill_step(cfg: ModelConfig, device=None, *, mesh=None, example_params=None,
                      example_cache=None, example_batch=None, fsdp: bool = False):
    """``prefill(params, batch, cache) -> (logits (B, 1, V), cache)``: the
    prompt in ``batch["tokens"]`` (or ``"embeds"``, plus ``"enc_out"`` for
    an encoder-decoder) from position 0; logits of the last position."""
    place, ctx = _placer(device, mesh, example_params, example_cache, fsdp)

    def prefill(params, batch, cache):
        with get_tracer().span("serve.prefill"), torch.no_grad():
            get_registry().counter("serve.prefills").inc()
            params, batch, cache = place(params, batch, cache)
            with ctx():
                logits, cache = forward(params, cfg, batch.get("tokens"),
                                        embeds=batch.get("embeds"), cache=cache,
                                        pos_offset=0, enc_out=batch.get("enc_out"),
                                        last_only=True)
                if isinstance(logits, DTensor):
                    spec = batch_specs({"l": logits}, logits.device_mesh,
                                       dp_axes=dp_axes(logits.device_mesh))["l"]
                    logits = shard_tree(logits, spec, logits.device_mesh)
            return logits, cache

    return prefill


def _greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    return torch.argmax(vocab_pad_mask(logits[:, -1].float(), vocab), dim=-1).to(torch.int32)


def make_decode_step(cfg: ModelConfig, device=None, *, mesh=None, example_params=None,
                     example_cache=None, example_batch=None, fsdp: bool = False):
    """``decode(params, batch, cache, pos) -> (next_tok (B,) int32, cache)``:
    one token for every sequence in the batch at position ``pos`` (a host
    int), greedy argmax sampling over the valid vocab."""
    place, ctx = _placer(device, mesh, example_params, example_cache, fsdp)

    def decode(params, batch, cache, pos: int):
        with get_tracer().span("serve.decode", pos=int(pos)), torch.no_grad():
            get_registry().counter("serve.decodes").inc()
            params, batch, cache = place(params, batch, cache)
            with ctx():
                logits, cache = forward(params, cfg, batch.get("tokens"),
                                        embeds=batch.get("embeds"), cache=cache,
                                        pos_offset=int(pos))
                rows = spec_of(batch.get("tokens", batch.get("embeds")))
                rows = (rows[0],) if rows is not None else (None,)
                return local(lambda lg: _greedy(lg, cfg.vocab), (logits,),
                             (rows + (None, None),), rows), cache

    return decode
