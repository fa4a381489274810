"""Shared neural-net primitives on tensors (dict params, functional apply).

Each function mirrors the reference's ``repro.models.layers`` op for op, so
a float32 run agrees with it to rounding: ``rms_norm`` normalizes in float32
and scales by ``1 + scale``; ``rotary`` rotates the two halves of the head
dimension (not interleaved pairs); pad logits are set to ``-1e30``.
"""
from __future__ import annotations

import dataclasses

import torch


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the config's dtype strings)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class Init:
    """Where parameters are drawn: ``device`` and a generator on it (``None``
    on the ``meta`` device, where only shapes are made), and ``lead``, the
    leading shape every leaf gets (a scan stage's period axis)."""

    device: torch.device
    generator: torch.Generator | None
    lead: tuple = ()

    def stacked(self, n: int) -> "Init":
        return dataclasses.replace(self, lead=(n,) + self.lead)

    def normal(self, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
        """Standard normal draws in float32, cast to ``dtype`` and scaled
        there (the reference's ``uniform_init``)."""
        shape = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        z = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return z.to(dtype) * scale

    def dense(self, d_in: int, d_out: int, dtype: torch.dtype, shape=None) -> torch.Tensor:
        return self.normal(shape or (d_in, d_out), d_in ** -0.5, dtype)

    def full(self, shape, value: float, dtype: torch.dtype) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=dtype, device=self.device)

    def tile(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``t`` repeated over the leading shape."""
        t = t.to(device=self.device, dtype=dtype)
        return t.expand(self.lead + tuple(t.shape)).clone()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE, half-split. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.long()]


def vocab_pad_mask(logits: torch.Tensor, valid_vocab: int) -> torch.Tensor:
    """-1e30 on the padded vocab tail so pad ids never receive probability mass."""
    vp = logits.shape[-1]
    if vp == valid_vocab:
        return logits
    keep = torch.arange(vp, device=logits.device) < valid_vocab
    return torch.where(keep, logits, -1e30)


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, final_cap: float = 0.0,
    valid_vocab: int | None = None,
) -> torch.Tensor:
    """Mean token cross-entropy; logits promoted to float32, soft-capped, then
    pad-masked (the reference's order)."""
    logits = logits.float()
    if final_cap > 0:
        logits = softcap(logits, final_cap)
    if valid_vocab is not None:
        logits = vocab_pad_mask(logits, valid_vocab)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()
