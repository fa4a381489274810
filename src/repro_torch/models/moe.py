"""Token-choice top-k MoE with capacity-bounded dispatch.

The reference's dispatch: flatten (token, expert-choice) pairs in
token-major, choice-minor order, rank each pair within its expert by a
one-hot cumsum, drop the pairs past capacity, scatter the rest into a dense
(E, C, d) buffer, run the expert FFNs as stacked einsums, and combine with
the router gates. The scatter is ``index_add_``: each kept slot receives
exactly one pair and a dropped pair adds zero, so its order does not matter.

Supports arctic's parallel dense residual MLP via ``moe_dense_ff``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init
from repro_torch.models.mlp import init_mlp, mlp


def init_moe(init: Init, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": init.dense(d, E, torch.float32),
        "w1": init.dense(d, f, dtype, (E, d, f)),
        "w2": init.dense(f, d, dtype, (E, f, d)),
        "w3": init.dense(d, f, dtype, (E, d, f)),
    }
    if cfg.moe_dense_ff:
        p["dense"] = init_mlp(init, d, cfg.moe_dense_ff, True, dtype)
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: no drops for up to 4096 pairs (decode, small
    batches), the capacity factor's share beyond."""
    pairs = n_tokens * cfg.top_k
    return pairs if pairs <= 4096 else max(1, int(cfg.capacity_factor * pairs / cfg.n_experts))


def route(p: dict, xt: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(gate, choice), each (N, k): the top-k router probabilities,
    renormalized over k, and their experts."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)  # (N, E)
    gate, choice = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return gate, choice


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    C = capacity(cfg, N)
    xt = x.reshape(N, d)
    gate, choice = route(p, xt, cfg)

    e_flat = choice.reshape(N * k)
    onehot = F.one_hot(e_flat, E).to(torch.int32)  # (N*k, E)
    pos = torch.gather(torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1, 1,
                       e_flat[:, None])[:, 0]
    keep = pos < C
    slot = e_flat * C + torch.where(keep, pos, 0)

    x_rep = xt.repeat_interleave(k, dim=0)  # (N*k, d) pairs
    buf = torch.zeros((E * C, d), dtype=x.dtype, device=x.device).index_add_(
        0, slot, torch.where(keep[:, None], x_rep, 0))
    h = buf.reshape(E, C, d)
    a = torch.einsum("ecd,edf->ecf", h, p["w1"])
    g = torch.einsum("ecd,edf->ecf", h, p["w3"])
    y = torch.einsum("ecf,efd->ecd", F.silu(a) * g, p["w2"])

    out_pairs = y.reshape(E * C, d)[slot] * (keep * gate.reshape(N * k))[:, None]
    out = out_pairs.reshape(N, k, d).sum(dim=1).reshape(B, S, d)
    if "dense" in p:  # arctic dense-residual path runs in parallel with experts
        out = out + mlp(p["dense"], x, True)
    return out.to(x.dtype)
