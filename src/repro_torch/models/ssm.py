"""Mamba1 (selective scan) and Mamba2 (SSD) blocks.

Both use the reference's chunked formulation (a loop over chunks of
``cfg.ssm_chunk`` tokens), so the (B, S, d_inner, N) state tensor is never
materialized for the whole sequence. Within a chunk Mamba1 runs an
inclusive scan of the recurrence h_t = a_t h_{t-1} + b_t by doubling
(log2 Q steps, each one elementwise pass: exact in math, as the reference's
``associative_scan`` is); Mamba2 uses the SSD matmul form (intra-chunk
attention-like products + inter-chunk state products). Decode is a
single-step state update.

On a mesh the reference's tags apply: the projections and each chunk's
inputs over the batch ("dp") and channels ("model"), or, for a config
that opts its SSM layers out of tensor parallelism (``ssm_tp=False``),
over every axis on the batch ("dpm") and nothing on channels. The zero
state and the causal mask are lifted to replicated DTensors; the SSD
prefix sum runs on each rank's shard (its dim is never sharded).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.constraints import constrain, einsum, local, matmul, replicated, spec_of
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, rms_norm


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C), w: (K,C), b: (C,)."""
    K, S = w.shape[0], x.shape[1]
    pad = torch.cat([torch.zeros_like(x[:, :1]).expand(-1, K - 1, -1), x], dim=1)
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return out + b


def _conv_step(state: torch.Tensor, xt: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Single-token conv. state: (B,K-1,C), xt: (B,1,C) -> (y, new_state)."""
    window = torch.cat([state, xt], dim=1)  # (B,K,C)
    y = einsum("bkc,kc->bc", window, w) + b
    return y[:, None], window[:, 1:]


def _conv_tail(x: torch.Tensor, K: int) -> torch.Tensor:
    """The last K-1 inputs, the conv state a prefill leaves in the cache."""
    if x.shape[1] < K - 1:
        raise ValueError(f"a prefill of {x.shape[1]} tokens cannot fill a conv state of {K - 1}")
    return x[:, -(K - 1):, :]


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------


def _dt_rank(cfg: ModelConfig) -> int:
    return -(-cfg.d_model // 16)


def _tags(cfg: ModelConfig) -> tuple:
    """(batch tag, channel tag): SSM layers with TP shard channels over
    the model axis; without it the batch takes every axis."""
    return ("dp", "model") if cfg.ssm_tp else ("dpm", None)


def init_mamba1(init: Init, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.conv_kernel
    R = _dt_rank(cfg)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32)).expand(di, N)
    return {
        "x_in": init.dense(d, di, dtype),
        "z_proj": init.dense(d, di, dtype),
        "conv_w": init.normal((K, di), K ** -0.5, dtype),
        "conv_b": init.full((di,), 0.0, dtype),
        "x_proj": init.dense(di, R + 2 * N, dtype),
        "dt_proj": init.dense(R, di, dtype),
        "dt_bias": init.full((di,), -4.6, dtype),  # softplus^-1(0.01)
        "A_log": init.tile(a_log, torch.float32),
        "Dskip": init.full((di,), 1.0, dtype),
        "out_proj": init.dense(di, d, dtype),
    }


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs (a, b) under
    (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2): returns (prod a, h) with
    h_t = a_t h_{t-1} + b_t from h_{-1} = 0, by doubling."""
    Q = a.shape[1]
    shift = 1
    while shift < Q:
        b = torch.cat([b[:, :shift], b[:, :-shift] * a[:, shift:] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return a, b


def mamba1(p: dict, u: torch.Tensor, cfg: ModelConfig, cache: dict | None = None):
    """u: (B,S,d). Returns (out, new_cache)."""
    B, S, d = u.shape
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.conv_kernel
    R = _dt_rank(cfg)
    bt, ct = _tags(cfg)
    x = constrain(matmul(u, p["x_in"]), bt, None, ct)
    z = constrain(matmul(u, p["z_proj"]), bt, None, ct)

    if cache is not None and S == 1:
        xc, conv_state = _conv_step(cache["conv"], x, p["conv_w"], p["conv_b"])
    else:
        xc = _causal_conv(x, p["conv_w"], p["conv_b"])
        conv_state = _conv_tail(x, K) if cache is not None else None
    x = F.silu(xc)

    dbc = matmul(x, p["x_proj"])
    dt = F.softplus(matmul(dbc[..., :R], p["dt_proj"]) + p["dt_bias"]).float()
    Bc = dbc[..., R:R + N].float()
    Cc = dbc[..., R + N:].float()
    A = -torch.exp(p["A_log"])  # (di,N)
    xf = x.float()

    if cache is not None and S == 1:
        h = cache["h"]  # (B,di,N)
        da = torch.exp(dt[:, 0, :, None] * A)
        h = da * h + (dt * xf)[:, 0, :, None] * Bc[:, 0, None, :]
        y = einsum("bdn,bn->bd", h, Cc[:, 0])[:, None]
        new_cache = {"conv": conv_state, "h": h}
    else:
        Q = min(cfg.ssm_chunk, S)
        if S % Q:
            raise ValueError(f"sequence length {S} is no multiple of the chunk {Q}")
        nc = S // Q
        da = torch.exp(dt[..., None] * A).reshape(B, nc, Q, di, N)
        db = ((dt * xf)[..., None] * Bc[:, :, None, :]).reshape(B, nc, Q, di, N)
        Ccc = Cc.reshape(B, nc, Q, N)
        h = cache["h"] if cache is not None else replicated(torch.zeros(
            (B, di, N), dtype=torch.float32, device=u.device), u)
        ys = []
        for c in range(nc):
            cum_a, h_within = _linear_scan(constrain(da[:, c], bt, None, ct, None),
                                           constrain(db[:, c], bt, None, ct, None))
            h_t = h_within + cum_a * h[:, None]
            ys.append(einsum("bqdn,bqn->bqd", h_t, Ccc[:, c]))
            h = h_t[:, -1]
        y = torch.stack(ys, dim=1).reshape(B, S, di)
        new_cache = {"conv": conv_state, "h": h} if cache is not None else None

    y = (y + xf * p["Dskip"].float()).to(u.dtype)
    out = matmul(y * F.silu(z), p["out_proj"])
    return out, new_cache


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def init_mamba2(init: Init, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.conv_kernel
    nh = di // cfg.mamba_headdim
    return {
        "z_proj": init.dense(d, di, dtype),
        "x_in": init.dense(d, di, dtype),
        "bc_proj": init.dense(d, 2 * N, dtype),
        "dtp": init.dense(d, nh, dtype),
        "conv_w": init.normal((K, di), K ** -0.5, dtype),
        "conv_b": init.full((di,), 0.0, dtype),
        "conv_bc_w": init.normal((K, 2 * N), K ** -0.5, dtype),
        "conv_bc_b": init.full((2 * N,), 0.0, dtype),
        "A_log": init.full((nh,), 0.0, torch.float32),
        "dt_bias": init.full((nh,), -4.6, torch.float32),
        "Dskip": init.full((nh,), 1.0, dtype),
        "norm": init.full((di,), 0.0, dtype),
        "out_proj": init.dense(di, d, dtype),
    }


def mamba2(p: dict, u: torch.Tensor, cfg: ModelConfig, cache: dict | None = None):
    B, S, d = u.shape
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.conv_kernel
    hp = cfg.mamba_headdim
    nh = di // hp
    bt, ct = _tags(cfg)
    z = constrain(matmul(u, p["z_proj"]), bt, None, ct)
    xr = constrain(matmul(u, p["x_in"]), bt, None, ct)
    bc = matmul(u, p["bc_proj"])
    dt = constrain(matmul(u, p["dtp"]), bt, None, ct)

    if cache is not None and S == 1:
        x, conv_state = _conv_step(cache["conv"], xr, p["conv_w"], p["conv_b"])
        bc, conv_bc_state = _conv_step(cache["conv_bc"], bc, p["conv_bc_w"], p["conv_bc_b"])
    else:
        conv_state = _conv_tail(xr, K) if cache is not None else None
        conv_bc_state = _conv_tail(bc, K) if cache is not None else None
        x = _causal_conv(xr, p["conv_w"], p["conv_b"])
        bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"])
    x = F.silu(x)
    bc = F.silu(bc)
    Bc, Cc = torch.chunk(bc, 2, dim=-1)
    x = constrain(x.reshape(B, S, nh, hp).float(), bt, None, ct, None)
    Bc, Cc = Bc.float(), Cc.float()
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,S,nh)
    A = -torch.exp(p["A_log"])  # (nh,)
    la = dt * A  # (B,S,nh) log-decay per step (negative)
    xdt = x * dt[..., None]  # (B,S,nh,hp)

    if cache is not None and S == 1:
        h = cache["h"]  # (B,nh,N,hp)
        h = torch.exp(la)[:, 0, :, None, None] * h + einsum(
            "bn,bhp->bhnp", Bc[:, 0], xdt[:, 0])
        y = einsum("bn,bhnp->bhp", Cc[:, 0], h)[:, None].reshape(B, 1, di)
        new_cache = {"conv": conv_state, "conv_bc": conv_bc_state, "h": h}
    else:
        Q = min(cfg.ssm_chunk, S)
        if S % Q:
            raise ValueError(f"sequence length {S} is no multiple of the chunk {Q}")
        nc = S // Q
        tri = replicated(torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
                         [None, :, :, None], u)
        h = cache["h"] if cache is not None else replicated(torch.zeros(
            (B, nh, N, hp), dtype=torch.float32, device=u.device), u)
        ys = []
        for c in range(nc):
            sl = slice(c * Q, (c + 1) * Q)
            la_c = constrain(la[:, sl], bt, None, ct)
            x_c = constrain(xdt[:, sl], bt, None, ct, None)
            B_c, C_c = Bc[:, sl], Cc[:, sl]
            spec = spec_of(la_c)
            cum = local(lambda t: torch.cumsum(t, dim=1), (la_c,), (None,), spec)  # (B,Q,nh)
            # intra-chunk: attention-like masked decay product. Above the
            # diagonal exp(cum_q - cum_p) overflows; the mask discards it.
            M = einsum("bqn,bpn->bqp", C_c, B_c)  # (B,Q,Q)
            L = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # (B,q,p,nh)
            W = torch.where(tri, M[..., None] * L, 0.0)
            y_intra = einsum("bqph,bphd->bqhd", W, x_c)
            # inter-chunk: contribution of the carried state
            y_inter = einsum("bqn,bhnd->bqhd", C_c, h) * torch.exp(cum)[..., None]
            # new carried state
            decay_tail = torch.exp(cum[:, -1:, :] - cum)  # (B,Q,nh)
            h = torch.exp(cum[:, -1])[:, :, None, None] * h + einsum(
                "bpn,bphd->bhnd", B_c, x_c * decay_tail[..., None])
            ys.append(y_intra + y_inter)
        y = torch.cat(ys, dim=1).reshape(B, S, di)
        new_cache = ({"conv": conv_state, "conv_bc": conv_bc_state, "h": h}
                     if cache is not None else None)

    y = y + (x * p["Dskip"].float()[None, None, :, None]).reshape(B, S, di)
    y = rms_norm(y.to(u.dtype) * F.silu(z), p["norm"], cfg.norm_eps)
    out = matmul(y, p["out_proj"])
    return out, new_cache
