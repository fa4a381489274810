"""The reference's parameters (and AdamW state) in the port's layout.

The two trees share keys and shapes (stacked scan slots, the ``shared``
blocks, the encoder), so the mapping is key for key: each array becomes a
tensor, after a check of the key, shape and dtype against the port's own
tree for the config (``init_params(cfg, device="meta")``). It takes numpy
arrays (``jax.tree.map(np.asarray, params)`` on the reference's side), so
nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, tree_map


def params_from_reference(cfg: ModelConfig, tree) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's CPU
    tensors, key for key."""
    return _convert(init_params(cfg, device="meta"), tree, "params")


def opt_state_from_reference(cfg: ModelConfig, tree, state_dtype=torch.float32) -> dict:
    """The reference's AdamW state ``{"m", "v", "step"}`` (numpy leaves) as
    the port's: the moments key for key as the parameter tree, in
    ``state_dtype``, and ``step`` a 0-d int32 tensor."""
    want = tree_map(lambda t: t.to(state_dtype), init_params(cfg, device="meta"))
    if set(tree) != {"m", "v", "step"}:
        raise ValueError(f"opt_state: keys {sorted(tree)} != ['m', 'step', 'v']")
    step = _tensor(np.asarray(tree["step"]))
    if step.shape != () or step.dtype != torch.int32:
        raise ValueError(f"opt_state.step: {step.dtype}{tuple(step.shape)}, want a 0-d int32")
    return {"m": _convert(want, tree["m"], "opt_state.m"),
            "v": _convert(want, tree["v"], "opt_state.v"), "step": step}


def _convert(want, got, path: str):
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path}: keys {sorted(got) if isinstance(got, dict) else got!r} "
                             f"!= {sorted(want)}")
        return {k: _convert(want[k], got[k], f"{path}.{k}") for k in want}
    if isinstance(want, list):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"{path}: {len(want)} stages expected")
        return [_convert(w, g, f"{path}[{i}]") for i, (w, g) in enumerate(zip(want, got))]
    t = _tensor(np.asarray(got))
    if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
        raise ValueError(f"{path}: {t.dtype}{tuple(t.shape)} where the port has "
                         f"{want.dtype}{tuple(want.shape)}")
    return t


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))
