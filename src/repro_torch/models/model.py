"""Model assembly: the pattern-driven stage plan of the reference.

The layer stack is planned into **stages**:
* a ``scan`` stage covers ``n`` repetitions of the config's pattern period;
  each slot's parameters are stacked on a leading period axis, and the
  periods run in a Python loop;
* a ``block`` stage is a single layer (pattern remainders, shared blocks).

Shared blocks (zamba2's ``H``) keep ONE parameter set for every period,
while their KV caches remain per period (stacked). The parameter and cache
trees have the reference's keys and shapes (``convert.params_from_reference``
maps one onto the other); a cache's ``pos`` is a host int.

``forward`` updates a cache in place and returns it. ``remat`` (the
reference's ``jax.checkpoint`` of each ``block`` stage and of each period of
a ``scan`` stage) applies under grad mode without a cache: each such unit
runs under ``remat.checkpointed``, so the backward keeps one activation per
unit and recomputes the rest. The period's parameters are indexed out of the
stacked tensors inside the recomputed unit, so their gradients reach the
stacked tensors; a shared block's parameters are closed over.

On a mesh (``distributed.constraints``) each block starts by constraining
the residual stream to the batch over the data axes, as the reference does;
a cache leaf is written through its local shard, the new value placed as
the cache is.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.distributed.constraints import constrain, matmul
from repro_torch.models.attention import attention, init_attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, cross_entropy, embed_lookup, rms_norm, torch_dtype
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.remat import checkpointed
from repro_torch.models.ssm import init_mamba1, init_mamba2, mamba1, mamba2

@dataclasses.dataclass(frozen=True)
class StageSpec:
    type: str  # "scan" | "block"
    pattern: str  # kinds within one period (scan) or single kind (block)
    n: int  # number of periods (scan) or 1


def build_stage_plan(pattern: str, kinds: tuple[str, ...]) -> list[StageSpec]:
    period = pattern if len(set(pattern)) > 1 else (kinds[0] if kinds else "A")
    plan: list[StageSpec] = []
    n_layers = len(kinds)
    if len(period) > 1:
        n_periods = n_layers // len(period)
        if n_periods > 0:
            plan.append(StageSpec("scan", period, n_periods))
        for k in kinds[n_periods * len(period):]:
            plan.append(StageSpec("block", k, 1))
    else:
        plan.append(StageSpec("scan", period[0], n_layers))
    # merge: a scan with a single period is just blocks
    out: list[StageSpec] = []
    for s in plan:
        if s.type == "scan" and s.n == 1:
            out.extend(StageSpec("block", k, 1) for k in s.pattern)
        else:
            out.append(s)
    return out


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of a tree of dicts and lists; other
    leaves (a cache's host-int ``pos``) are kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(init: Init, kind: str, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    if kind == "M":
        return {"ln": init.full((d,), 0.0, dtype), "mix": init_mamba1(init, cfg, dtype)}
    if kind == "S":
        return {"ln": init.full((d,), 0.0, dtype), "mix": init_mamba2(init, cfg, dtype)}
    p = {
        "ln1": init.full((d,), 0.0, dtype),
        "attn": init_attn(init, cfg, dtype),
        "ln2": init.full((d,), 0.0, dtype),
    }
    if kind == "E":
        p["moe"] = init_moe(init, cfg, dtype)
    else:
        p["mlp"] = init_mlp(init, d, cfg.d_ff, cfg.mlp_gated, dtype)
    if kind == "C":
        p["lnx"] = init.full((d,), 0.0, dtype)
        p["xattn"] = init_attn(init, cfg, dtype)
    return p


def _init_stage(init: Init, spec: StageSpec, cfg: ModelConfig, dtype) -> dict:
    if spec.type == "block":
        return {"block": _init_block(init, spec.pattern, cfg, dtype)}
    slots: dict = {}
    shared: dict = {}
    for j, kind in enumerate(spec.pattern):
        if kind == "H":  # one shared parameter set for all periods
            shared[str(j)] = _init_block(init, kind, cfg, dtype)
        else:
            slots[str(j)] = _init_block(init.stacked(spec.n), kind, cfg, dtype)
    return {"slots": slots, "shared": shared}


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None, *,
                device=None) -> dict:
    """Random parameters with the reference's tree, shapes and dtypes, drawn
    from ``generator`` (on ``device``; seed 0 when None). ``device="meta"``
    makes the shapes alone (``param_count`` of a full config)."""
    if str(device) == "meta":
        init = Init(torch.device("meta"), None)
    else:
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        elif generator.device.type != dev.type:
            raise ValueError(f"a generator on {generator.device} cannot draw on {dev}")
        init = Init(dev, generator)
    dtype = torch_dtype(cfg.param_dtype)
    params: dict = {}
    if cfg.input_kind == "tokens" or cfg.vocab:
        params["embed"] = init.dense(cfg.padded_vocab, cfg.d_model, dtype,
                                     (cfg.padded_vocab, cfg.d_model))
    plan = build_stage_plan(cfg.pattern, cfg.layer_kinds)
    params["stages"] = [_init_stage(init, s, cfg, dtype) for s in plan]
    params["final_norm"] = init.full((cfg.d_model,), 0.0, dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = init.dense(cfg.d_model, cfg.padded_vocab, dtype)
    if cfg.enc_layers:
        enc_plan = build_stage_plan(cfg.enc_pattern, cfg.enc_layer_kinds)
        params["encoder"] = {
            "stages": [_init_stage(init, s, cfg, dtype) for s in enc_plan],
            "final_norm": init.full((cfg.d_model,), 0.0, dtype),
        }
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def _block_cache(kind: str, cfg: ModelConfig, batch: int, max_seq: int, dtype, lead, dev):
    def zeros(shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=dev)

    if kind == "M":
        return {
            "conv": zeros((batch, cfg.conv_kernel - 1, cfg.d_inner)),
            "h": zeros((batch, cfg.d_inner, cfg.ssm_state), torch.float32),
        }
    if kind == "S":
        nh = cfg.d_inner // cfg.mamba_headdim
        return {
            "conv": zeros((batch, cfg.conv_kernel - 1, cfg.d_inner)),
            "conv_bc": zeros((batch, cfg.conv_kernel - 1, 2 * cfg.ssm_state)),
            "h": zeros((batch, nh, cfg.ssm_state, cfg.mamba_headdim), torch.float32),
        }
    c = {
        "attn": {
            "k": zeros((batch, max_seq, cfg.n_kv, cfg.hd)),
            "v": zeros((batch, max_seq, cfg.n_kv, cfg.hd)),
            "pos": 0,
        }
    }
    if kind == "C":
        c["cross"] = {
            "k": zeros((batch, cfg.enc_seq or max_seq, cfg.n_kv, cfg.hd)),
            "v": zeros((batch, cfg.enc_seq or max_seq, cfg.n_kv, cfg.hd)),
        }
    return c


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device=None) -> list:
    """A zero decode cache for ``batch`` sequences of up to ``max_seq``
    tokens, on ``device``; ``device="meta"`` makes the shapes alone."""
    dtype = torch_dtype(cfg.dtype)
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    caches = []
    for spec in build_stage_plan(cfg.pattern, cfg.layer_kinds):
        if spec.type == "block":
            caches.append({"block": _block_cache(spec.pattern, cfg, batch, max_seq, dtype,
                                                 (), dev)})
        else:
            caches.append({"slots": {
                str(j): _block_cache(kind, cfg, batch, max_seq, dtype, (spec.n,), dev)
                for j, kind in enumerate(spec.pattern)}})
    return caches


def _period(tree: dict, t: int) -> dict:
    """Period ``t`` of a stacked tree: views of its tensors."""
    return {k: _period(v, t) if isinstance(v, dict) else
            (v[t] if isinstance(v, torch.Tensor) else v) for k, v in tree.items()}


def _store(dst: dict, new: dict, t: int | None = None, last: bool = True) -> None:
    """Write a block's new cache into ``dst`` (its period ``t`` when the
    tree is stacked). Tensors the block updated in place are left alone;
    ``pos``, one for all periods, moves with the ``last`` period."""
    for key, val in new.items():
        if isinstance(val, dict):
            _store(dst[key], val, t, last)
        elif not isinstance(val, torch.Tensor):
            if last:
                dst[key] = val  # pos
        else:
            view = dst[key] if t is None else dst[key][t]
            if val.shape != view.shape:
                raise ValueError(f"cache {key!r}: new shape {tuple(val.shape)} does not fit "
                                 f"the cache's {tuple(view.shape)}")
            if isinstance(view, DTensor):
                val = val.redistribute(view.device_mesh, view.placements).to_local()
                view = view.to_local()
            if val.data_ptr() != view.data_ptr():
                view.copy_(val)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _apply_block(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions,
                 cache=None, enc_out=None, causal=True):
    x = constrain(x, "dp", None, None)  # residual stream: batch over the data axes
    if kind in ("M", "S"):
        fn = mamba1 if kind == "M" else mamba2
        out, new_c = fn(p["mix"], rms_norm(x, p["ln"], cfg.norm_eps), cfg, cache)
        return x + out.to(x.dtype), new_c
    new_cache = dict(cache) if cache is not None else None
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    window = cfg.sliding_window if kind == "L" else 0
    a, c_attn = attention(
        p["attn"], h, cfg, positions=positions, window=window,
        cache=cache["attn"] if cache else None, causal=causal,
    )
    if new_cache is not None:
        new_cache["attn"] = c_attn
    x = x + a.to(x.dtype)
    if kind == "C" and (enc_out is not None or cache is not None):
        h = rms_norm(x, p["lnx"], cfg.norm_eps)
        xc = cache["cross"] if cache else None
        a, nxc = attention(p["xattn"], h, cfg, positions=positions, cache=xc,
                           kv_source=enc_out, is_cross=True)
        if new_cache is not None:
            new_cache["cross"] = nxc
        x = x + a.to(x.dtype)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    f = moe_ffn(p["moe"], h, cfg) if kind == "E" else mlp(p["mlp"], h, cfg.mlp_gated)
    return x + f.to(x.dtype), new_cache


def _apply_stages(stages_params: list, plan: list[StageSpec], x: torch.Tensor,
                  cfg: ModelConfig, *, positions, caches=None, enc_out=None, causal=True,
                  remat=False):
    remat = remat and caches is None and torch.is_grad_enabled()
    # the units below bind their stage through default arguments: under
    # remat the backward runs them again after this loop has moved on
    for i, spec in enumerate(plan):
        sp = stages_params[i]
        cache_i = caches[i] if caches is not None else None
        if spec.type == "block":
            def block(p, h, kind=spec.pattern, c=cache_i["block"] if cache_i else None):
                h, nc = _apply_block(kind, p, h, cfg, positions=positions, cache=c,
                                     enc_out=enc_out, causal=causal)
                if c is not None:
                    _store(c, nc)
                return h

            x = checkpointed(block, sp["block"], x) if remat else block(sp["block"], x)
            continue

        def period(h, t, spec=spec, sp=sp, slot_caches=cache_i["slots"] if cache_i else None):
            for j, kind in enumerate(spec.pattern):
                p_j = sp["shared"][str(j)] if kind == "H" else _period(sp["slots"][str(j)], t)
                c_j = _period(slot_caches[str(j)], t) if slot_caches else None
                h, nc_j = _apply_block(kind, p_j, h, cfg, positions=positions, cache=c_j,
                                       enc_out=enc_out, causal=causal)
                if nc_j is not None:
                    _store(slot_caches[str(j)], nc_j, t, last=t == spec.n - 1)
            return h

        for t in range(spec.n):
            x = checkpointed(period, x, t) if remat else period(x, t)
    return x


def encode(params: dict, cfg: ModelConfig, enc_embeds: torch.Tensor) -> torch.Tensor:
    """Run the (bidirectional) encoder over stub modality embeddings."""
    plan = build_stage_plan(cfg.enc_pattern, cfg.enc_layer_kinds)
    pos = torch.arange(enc_embeds.shape[1], device=enc_embeds.device)
    x = _apply_stages(params["encoder"]["stages"], plan, enc_embeds.to(torch_dtype(cfg.dtype)),
                      cfg, positions=pos, causal=False)
    return rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor | None = None,  # (B, S) int
    embeds: torch.Tensor | None = None,  # (B, S, d) modality-stub inputs
    *,
    cache: list | None = None,
    pos_offset: int = 0,
    enc_out: torch.Tensor | None = None,
    remat: bool = False,
    last_only: bool = False,
):
    """Returns (logits (B,S,padded_vocab), cache). ``cache`` is updated in
    place. ``last_only`` computes the LM head for the final position only
    (prefill: avoids a (B,S,V) buffer)."""
    if embeds is None:
        embeds = embed_lookup(params["embed"], tokens)
    dtype = torch_dtype(cfg.dtype)
    x = embeds.to(dtype)
    if enc_out is not None:
        enc_out = enc_out.to(dtype)
    S = x.shape[1]
    positions = pos_offset + torch.arange(S, device=x.device)
    plan = build_stage_plan(cfg.pattern, cfg.layer_kinds)
    x = _apply_stages(params["stages"], plan, x, cfg, positions=positions, caches=cache,
                      enc_out=enc_out, causal=True, remat=remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = matmul(x, head)
    return logits, cache


def loss_fn(
    params: dict, cfg: ModelConfig, tokens: torch.Tensor, labels: torch.Tensor,
    embeds: torch.Tensor | None = None, enc_embeds: torch.Tensor | None = None,
    remat: bool = True,
) -> torch.Tensor:
    enc_out = encode(params, cfg, enc_embeds) if enc_embeds is not None else None
    logits, _ = forward(params, cfg, tokens, embeds=embeds, enc_out=enc_out, remat=remat)
    return cross_entropy(logits, labels, cfg.final_softcap, valid_vocab=cfg.vocab)
