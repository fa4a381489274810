"""Shared neural-net primitives on tensors (dict params, functional apply).

Each function mirrors the reference's ``repro.models.layers`` op for op, so
a float32 run agrees with it to rounding: ``rms_norm`` normalizes in float32
and scales by ``1 + scale``; ``rotary`` rotates the two halves of the head
dimension (not interleaved pairs); pad logits are set to ``-1e30``.

On a mesh (DTensor activations, ``distributed.constraints``) the tables
built here (rotary angles, the vocab mask) are lifted to replicated
DTensors where they meet an activation; the embedding lookup runs on each
rank's ids against its own rows of the table (a partial sum, exact), and
the cross-entropy on each rank's rows with the vocab gathered whole
(``constraints.local``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.distributed.constraints import local, replicated, spec_of


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
    cos = replicated(torch.cos(ang)[..., None, :], x)
    sin = replicated(torch.sin(ang)[..., None, :], x)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. On a mesh each rank looks up its own ids (placed as
    they are) in its own rows of the table (the vocab split over the mesh
    dims that do not split the ids; the table whole on the others): ids
    outside those rows give zeros, and the result is the partial sum over
    those mesh dims, exact (one shard holds each row)."""
    if not isinstance(table, DTensor):
        return table[ids.long()]
    mesh = table.device_mesh
    ids_pl = ids.placements if isinstance(ids, DTensor) else [Replicate()] * mesh.ndim
    vocab = [i for i, p in enumerate(table.placements)
             if p.is_shard() and p.dim == 0 and not ids_pl[i].is_shard()]
    rows = table.redistribute(mesh, [table.placements[i] if i in vocab else Replicate()
                                     for i in range(mesh.ndim)])
    local_ids = ids.to_local() if isinstance(ids, DTensor) else ids
    t = rows.to_local(grad_placements=[
        rows.placements[i] if i in vocab else Partial() if ids_pl[i].is_shard() else Replicate()
        for i in range(mesh.ndim)])
    idx = 0
    coord = mesh.get_coordinate()
    for i in vocab:
        idx = idx * mesh.size(i) + coord[i]
    lo, n = idx * t.shape[0], t.shape[0]
    ids_l = local_ids.long() - lo
    inside = (ids_l >= 0) & (ids_l < n)
    out = t[ids_l.clamp(0, n - 1)] * inside[..., None].to(t.dtype)
    return DTensor.from_local(out, mesh, [Partial() if i in vocab else ids_pl[i]
                                          for i in range(mesh.ndim)], run_check=False)


def vocab_pad_mask(logits: torch.Tensor, valid_vocab: int) -> torch.Tensor:
    """-1e30 on the padded vocab tail so pad ids never receive probability mass."""
    vp = logits.shape[-1]
    if vp == valid_vocab:
        return logits
    keep = replicated(torch.arange(vp, device=logits.device) < valid_vocab, logits)
    return torch.where(keep, logits, -1e30)


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, final_cap: float = 0.0,
    valid_vocab: int | None = None,
) -> torch.Tensor:
    """Mean token cross-entropy; logits promoted to float32, soft-capped, then
    pad-masked (the reference's order). On a mesh each rank takes the rows
    of its labels, the whole vocab gathered."""
    spec = spec_of(labels) or (None,) * labels.ndim
    nll = local(lambda lg, lb: _token_nll(lg, lb, final_cap, valid_vocab), (logits, labels),
                (spec + (None,), None), spec)
    return nll.mean()


def _token_nll(logits: torch.Tensor, labels: torch.Tensor, final_cap: float,
               valid_vocab: int | None) -> torch.Tensor:
    logits = logits.float()
    if final_cap > 0:
        logits = softcap(logits, final_cap)
    if valid_vocab is not None:
        logits = vocab_pad_mask(logits, valid_vocab)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold
