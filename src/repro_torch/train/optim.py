"""AdamW and the cosine schedule over the port's parameter trees.

The reference's arithmetic in float32 and its order of operations: a global
norm clip over every leaf, bias corrections ``1 - b**step`` in float32,
``u = (m/c1) / (sqrt(v/c2) + eps) + wd * p`` with weight decay on every
leaf, and each result cast back to its leaf's dtype. ``state_dtype`` sets
the moments' dtype (float32 by default).

Where the reference returns new trees (its buffers donated), the update here
writes the parameters and moments **in place**, under ``torch.no_grad``, and
returns the same trees.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.model import tree_leaves, tree_map


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (a host int or a tensor), a float32
    0-d tensor: linear warm-up from 0, then a cosine from ``peak_lr`` down
    to ``floor * peak_lr`` at ``total``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(1.0, warmup)
    frac = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def adamw_init(params, state_dtype: torch.dtype = torch.float32) -> dict:
    """Zero moments shaped as ``params`` (on their devices) and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step, in place. Returns ``(params, state, gnorm)``; ``grads``
    has the tree of ``params``."""
    state["step"] += 1
    flat_g = tree_leaves(grads)
    gsq = sum(torch.sum(torch.square(g.float())) for g in flat_g)  # float32 accumulation
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp_max(grad_clip / (gnorm + 1e-9), 1.0) if grad_clip > 0 else 1.0
    t = state["step"].float()
    c1 = 1 - torch.pow(b1, t)
    c2 = 1 - torch.pow(b2, t)
    for p, g, m, v in zip(tree_leaves(params), flat_g, tree_leaves(state["m"]),
                          tree_leaves(state["v"]), strict=True):
        g = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * torch.square(g)
        u = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        u = u + weight_decay * p.float()
        p.copy_(p.float() - lr * u)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, state, gnorm
