"""GQA attention (global / sliding-window / cross) with KV-cache decode.

The reference's arithmetic, op for op: float32 scores, the tanh soft-cap,
masked scores set to ``-1e30``, softmax in float32. GQA K/V heads are
repeated to H at use (``repeat_interleave``: head h reads KV head h // g);
the KV *cache* stays K-headed.

The cache is updated in place. A prefill whose length equals the cache's
writes the whole cache; any other call with a cache writes its K/V at
``cache["pos"]`` (a host int) and attends over the whole cache, masked.

Long sequences (S >= FLASH_THRESHOLD, keys as long as the queries) go
through ``_flash``: a chunked online softmax that holds one (chunk x chunk)
score block at a time and skips the key chunks the causal mask (and window)
leave empty, with the loop bounds as host ints. Without a cache (training)
it is differentiable: the backward recomputes each key chunk's block.

On a mesh the reference's ``constrain`` tags apply at its call sites:
queries and each chunk over heads, the GQA repeat over heads or (decode
sequence parallelism, ``REPRO_TORCH_DECODE_SP``, default ``"1"``) over the
cache's sequence. Positions, masks and the online softmax's running state
are lifted to replicated DTensors where they meet an activation. A cache
write touches only the part of the new K/V that falls in each rank's shard
of the cache (exact: the shards partition the cache).
"""
from __future__ import annotations

import functools
import os

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.constraints import constrain, einsum, replicated, spec_of
from repro_torch.distributed.sharding import placements
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, rotary, softcap
from repro_torch.models.remat import checkpointed, recomputing
from repro_torch.obs.metrics import get_registry

FLASH_THRESHOLD = 2048
FLASH_CHUNK = 1024
NEG = -1e30  # the masked-score sentinel
ENV_DECODE_SP = "REPRO_TORCH_DECODE_SP"


def _decode_sp(cache, k_len: int, S: int) -> bool:
    """Decode sequence parallelism: a call with a cache that attends over
    more keys than it brings keeps the cache's sequence dim sharded (the
    port's name for the reference's ``REPRO_DECODE_SP``; tags only)."""
    return cache is not None and k_len != S and os.environ.get(ENV_DECODE_SP, "1") == "1"


def head_pad_mask(cfg: ModelConfig, dtype=torch.float32, device=None) -> torch.Tensor | None:
    """1.0 for real Q-head slots, 0.0 for padding. Padding is per KV group
    (each group of g real heads pads to g_pad) so the GQA repeat keeps every
    real head aligned with its own KV head."""
    H, K = cfg.n_heads, cfg.n_kv
    Hp = max(H, cfg.head_pad_to)
    if Hp == H:
        return None
    if Hp % K:
        raise ValueError(f"head_pad_to {Hp} is no multiple of n_kv {K}")
    g, gp = H // K, Hp // K
    return ((torch.arange(Hp, device=device) % gp) < g).to(dtype)


def init_attn(init: Init, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    Hp = max(H, cfg.head_pad_to)
    if Hp % K:
        raise ValueError(f"{Hp} query heads do not split over {K} KV heads")
    p = {
        "wq": init.dense(d, H * hd, dtype, (d, Hp, hd)),
        "wk": init.dense(d, K * hd, dtype, (d, K, hd)),
        "wv": init.dense(d, K * hd, dtype, (d, K, hd)),
        "wo": init.dense(H * hd, d, dtype, (Hp, hd, d)),
    }
    mask = head_pad_mask(cfg, dtype, init.device)
    if mask is not None:  # zero padded heads: no contribution, zero gradients
        p["wq"] = p["wq"] * mask[:, None]
        p["wo"] = p["wo"] * mask[:, None, None]
    return p


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool, window: int):
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


def _repeat_kv(k: torch.Tensor, g: int, *, seq_sharded: bool = False) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, K*g, hd), each KV head repeated g times in
    place (head h reads KV head h // g). Head-sharded downstream by default;
    ``seq_sharded`` keeps the cache-sequence dim sharded instead (decode SP)."""
    if g == 1:
        return k
    B, S, K, hd = k.shape
    tags = ("dp", "model", None, None) if seq_sharded else ("dp", None, "model", None)
    return constrain(k[:, :, :, None].expand(B, S, K, g, hd).reshape(B, S, K * g, hd), *tags)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, h, k) -> (B, S, h, k)."""
    return einsum("bsd,dhk->bshk", x, w)


def _write(cache_t: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """``cache_t[:, pos:pos + S] = new`` in place. On a mesh each rank writes
    the rows of ``new`` that fall in its shard of the cache's sequence dim,
    ``new`` placed as the cache is in every other dim."""
    S = new.shape[1]
    if not isinstance(cache_t, DTensor):
        cache_t[:, pos:pos + S] = new
        return
    mesh = cache_t.device_mesh
    spec = spec_of(cache_t)
    new = new.redistribute(mesh, placements((spec[0], None) + spec[2:], mesh)).to_local()
    dst = cache_t.to_local()
    n = dst.shape[1]
    idx = 0
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    axes = () if spec[1] is None else (spec[1],) if isinstance(spec[1], str) else spec[1]
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + coord[a]
    lo = idx * n
    a, b = max(pos, lo), min(pos + S, lo + n)
    if a < b:
        dst[:, a - lo:b - lo] = new[:, a - pos:b - pos]


def _kv_step(m, l, acc, qc, kck, vck, q0: int, k0: int, *, cfg: ModelConfig, causal: bool,
             window: int, scale: float):
    """One key chunk of the online softmax: ``(m, l, acc)`` after the keys
    ``kck`` (from position ``k0``) for the queries ``qc`` (from ``q0``)."""
    cq, ck, dev = qc.shape[1], kck.shape[1], qc.device
    q_pos = q0 + torch.arange(cq, device=dev)
    k_pos = k0 + torch.arange(ck, device=dev)
    s = einsum("bshd,bthd->bhst", qc, kck).float() * scale
    if cfg.softcap > 0:
        s = softcap(s, cfg.softcap)
    mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    keep = replicated(mask[None, None], s)
    s = torch.where(keep, s, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    # fully-masked rows must add zero mass even while the running
    # max sits at the sentinel
    p = torch.where(keep, p, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = einsum("bhst,bthd->bhsd", p.to(qc.dtype), vck)
    return m_new, l_new, acc * corr[..., None].to(acc.dtype) + pv


def _flash(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, H, hd)  (already repeated to H)
    v: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool,
    window: int,
    chunk: int = FLASH_CHUNK,
    differentiable: bool = False,
) -> torch.Tensor:
    """Chunked online-softmax attention; counts its forward calls in the
    registry's ``attention.flash``. ``differentiable`` (under grad mode)
    runs each key chunk under ``remat.checkpointed``, so the backward
    recomputes every (cq x ck) probability block instead of keeping them
    all (the reference's ``jax.checkpoint`` of its scan body). Key chunks
    the causal mask (and window) leave empty are skipped in both forms: such
    a chunk leaves ``(m, l, acc)`` as they were (``corr = 1``, ``p = 0``)
    and so adds no gradient either."""
    if not recomputing():
        get_registry().counter("attention.flash").inc()
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    cq, ck = min(chunk, Sq), min(chunk, Sk)
    if Sq % cq or Sk % ck:
        raise ValueError(f"sequence lengths {Sq}, {Sk} are no multiple of the chunk {chunk}")
    nq, nk = Sq // cq, Sk // ck
    dev = q.device
    step = functools.partial(_kv_step, cfg=cfg, causal=causal, window=window, scale=hd ** -0.5)
    if differentiable:
        step = functools.partial(checkpointed, step)
    outs = []
    for qi in range(nq):
        qc = constrain(q[:, qi * cq:(qi + 1) * cq], "dp", None, "model", None)
        m = replicated(torch.full((B, H, cq), NEG, dtype=torch.float32, device=dev), q)
        l = replicated(torch.zeros((B, H, cq), dtype=torch.float32, device=dev), q)
        acc = replicated(torch.zeros((B, H, cq, hd), dtype=q.dtype, device=dev), q)
        if causal:  # key chunks past the diagonal (or before the window) add nothing
            hi = qi + 1
            lo = max(0, (qi * cq - window) // ck) if window > 0 else 0
        else:
            lo, hi = 0, nk
        for ki in range(lo, hi):
            kck = constrain(k[:, ki * ck:(ki + 1) * ck], "dp", None, "model", None)
            vck = constrain(v[:, ki * ck:(ki + 1) * ck], "dp", None, "model", None)
            m, l, acc = step(m, l, acc, qc, kck, vck, qi * cq, ki * ck)
        o = acc / torch.clamp_min(l, 1e-30)[..., None].to(acc.dtype)
        outs.append(o.transpose(1, 2))
    return torch.cat(outs, dim=1) if nq > 1 else outs[0].contiguous()


def attention(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (S,) absolute positions of x tokens
    window: int = 0,  # 0 = global
    cache: dict | None = None,  # self: {"k","v","pos"}; cross: {"k","v"}
    kv_source: torch.Tensor | None = None,  # cross-attention memory (B, S_kv, d)
    causal: bool = True,
    is_cross: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    B, S, d = x.shape
    K, hd = cfg.n_kv, cfg.hd
    H = p["wq"].shape[1]  # may exceed cfg.n_heads under head padding
    g = H // K
    q = _proj(x, p["wq"])
    q = constrain(q, "dp", None, "model", None)

    if is_cross:
        if kv_source is not None:  # (pre)fill: compute cross K/V from encoder
            k = _proj(kv_source, p["wk"])
            v = _proj(kv_source, p["wv"])
            cache = {"k": k, "v": v} if cache is not None else None
        else:  # decode: use precomputed cross K/V
            k, v = cache["k"], cache["v"]
        k, v = _repeat_kv(k, g), _repeat_kv(v, g)
        mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=x.device)
        sp = False
    else:
        k = _proj(x, p["wk"])
        v = _proj(x, p["wv"])
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
        if cache is not None and S == cache["k"].shape[1]:
            # full prefill: the fresh K/V are the cache (positions 0..S-1)
            _write(cache["k"], k, 0)
            _write(cache["v"], v, 0)
            cache = {"k": cache["k"], "v": cache["v"], "pos": S}
            mask = _mask(positions, positions, causal=causal, window=window)
        elif cache is not None:
            # decode: write the new k/v at `pos`, attend over the whole cache
            pos = int(cache["pos"])
            ck_, cv_ = cache["k"], cache["v"]
            _write(ck_, k, pos)
            _write(cv_, v, pos)
            k, v = ck_, cv_
            k_pos = torch.arange(k.shape[1], device=x.device)
            q_pos = pos + torch.arange(S, device=x.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            cache = {"k": ck_, "v": cv_, "pos": pos + S}
        else:
            mask = _mask(positions, positions, causal=causal, window=window)
        sp = _decode_sp(cache, k.shape[1], S)
        k, v = _repeat_kv(k, g, seq_sharded=sp), _repeat_kv(v, g, seq_sharded=sp)

    if not is_cross and k.shape[1] == S and S >= FLASH_THRESHOLD:
        # no cache: a train or eval call that may be differentiated
        out = _flash(q, k, v, cfg, causal=causal, window=window,
                     differentiable=cache is None)
    else:
        if sp:
            # decode SP: the cache shards its sequence dim over the model
            # axis (cache_specs); attention stays sharded over it
            q = constrain(q, "dp", None, None, None)
            k = constrain(k, "dp", "model", None, None)
            v = constrain(v, "dp", "model", None, None)
        scores = einsum("bshd,bthd->bhst", q, k).float()
        if sp:
            scores = constrain(scores, "dp", None, None, "model")
        scores = scores * (hd ** -0.5)
        if cfg.softcap > 0:
            scores = softcap(scores, cfg.softcap)
        scores = torch.where(replicated(mask[None, None], scores), scores, NEG)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = einsum("bhst,bthd->bshd", w, v)
    out = einsum("bshk,hkd->bsd", out, p["wo"])
    return out, cache

