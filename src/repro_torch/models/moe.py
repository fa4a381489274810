"""Token-choice top-k MoE with capacity-bounded dispatch.

The reference's dispatch: flatten (token, expert-choice) pairs in
token-major, choice-minor order, rank each pair within its expert by a
one-hot cumsum, drop the pairs past capacity, scatter the rest into a dense
(E, C, d) buffer, run the expert FFNs as stacked einsums, and combine with
the router gates. The scatter is ``index_add_``: each kept slot receives
exactly one pair and a dropped pair adds zero, so its order does not matter.

Supports arctic's parallel dense residual MLP via ``moe_dense_ff``.

On a mesh the reference's tags apply (tokens over the data axes, the
dispatch buffer over experts, and in decode the expert intermediates over
the data axes: weight-stationary, ``REPRO_TORCH_MOE_DECODE_WS``, default
``"1"``). The routing, the capacity ranking, the scatter into the buffer
and the combine's gather run whole on every rank (``constraints.local``,
tokens and the expert outputs gathered): the ranking is a prefix sum over
every token, and DTensor has no rule for the scatter.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.distributed.constraints import constrain, einsum, local
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init
from repro_torch.models.mlp import init_mlp, mlp


ENV_DECODE_WS = "REPRO_TORCH_MOE_DECODE_WS"


def _decode_weight_stationary() -> bool:
    """Decode keeps the expert weights sharded and moves the intermediates
    (the port's name for the reference's ``REPRO_MOE_DECODE_WS``; tags only)."""
    return os.environ.get(ENV_DECODE_WS, "1") == "1"


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


def _dispatch(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, C: int):
    """(gate (N*k,) with the dropped pairs zeroed, slot (N*k,)): each
    (token, choice) pair's router weight and its row in the (E*C) buffer."""
    N, k, E = xt.shape[0], cfg.top_k, cfg.n_experts
    gate, choice = route({"router": router}, xt, cfg)
    e_flat = choice.reshape(N * k)
    onehot = F.one_hot(e_flat, E).to(torch.int32)  # (N*k, E)
    pos = torch.gather(torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1, 1,
                       e_flat[:, None])[:, 0]
    keep = pos < C
    slot = e_flat * C + torch.where(keep, pos, 0)
    return keep * gate.reshape(N * k), slot, keep


def _scatter(x_rep: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor, rows: int):
    return torch.zeros((rows, x_rep.shape[1]), dtype=x_rep.dtype,
                       device=x_rep.device).index_add_(0, slot,
                                                       torch.where(keep[:, None], x_rep, 0))


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    C = capacity(cfg, N)
    xt = constrain(x.reshape(N, d), "dp", None)
    whole = (None, None)
    weight, slot, keep = local(lambda a, r: _dispatch(a, r, cfg, C), (xt, p["router"]),
                               (whole, whole), [(None,), (None,), (None,)])

    # (N*k, d) pairs, each token repeated k times in place
    x_rep = constrain(xt[:, None].expand(N, k, d).reshape(N * k, d), "dp", None)
    buf = local(lambda a, s_, kp: _scatter(a, s_, kp, E * C), (x_rep, slot, keep),
                (whole, (None,), (None,)), whole)
    # expert parallelism: the dispatch buffer lives expert-sharded
    h = constrain(buf.reshape(E, C, d), "model", None, None)
    a = einsum("ecd,edf->ecf", h, p["w1"])
    g = einsum("ecd,edf->ecf", h, p["w3"])
    if N * k <= 4096 and _decode_weight_stationary():
        # decode: expert weights stay sharded (E over model, f over the data
        # axes); the f-sharded intermediates move instead
        a = constrain(a, "model", None, "dp")
        g = constrain(g, "model", None, "dp")
    y = einsum("ecf,efd->ecd", F.silu(a) * g, p["w2"])
    y = constrain(y, "model", None, None)

    out_pairs = local(lambda y_, s_: y_.reshape(E * C, d)[s_], (y, slot),
                      ((None, None, None), (None,)), whole) * weight[:, None]
    out_pairs = constrain(out_pairs, "dp", None)
    out = out_pairs.reshape(N, k, d).sum(dim=1).reshape(B, S, d)
    if "dense" in p:  # arctic dense-residual path runs in parallel with experts
        out = out + mlp(p["dense"], x, True)
    return out.to(x.dtype)
