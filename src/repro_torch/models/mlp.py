"""Dense feed-forward blocks: SwiGLU (llama family) and plain GELU (granite)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.constraints import matmul
from repro_torch.models.layers import Init


def init_mlp(init: Init, d: int, f: int, gated: bool, dtype: torch.dtype) -> dict:
    p = {"w1": init.dense(d, f, dtype), "w2": init.dense(f, d, dtype)}
    if gated:
        p["w3"] = init.dense(d, f, dtype)
    return p


def mlp(p: dict, x: torch.Tensor, gated: bool) -> torch.Tensor:
    h = matmul(x, p["w1"])
    if gated:
        h = F.silu(h) * matmul(x, p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    return matmul(h, p["w2"])
