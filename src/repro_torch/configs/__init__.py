"""Architecture registry + the assigned input-shape cells (the port's own
copy of the reference's ``repro.configs``, field for field).

``--arch <id>`` resolution for launchers, plus the four LM shape cells:
  train_4k     seq 4096,   global_batch 256  -> train_step
  prefill_32k  seq 32768,  global_batch 32   -> prefill (serve)
  decode_32k   seq 32768,  global_batch 128  -> serve_step (1 token, KV cache)
  long_500k    seq 524288, global_batch 1    -> serve_step; sub-quadratic only

Skip rules: ``long_500k`` only for subquadratic archs
(zamba2-7b, falcon-mamba-7b); all archs here are decoder-bearing so decode
cells apply everywhere.
"""
from __future__ import annotations

import dataclasses
import importlib
import os

from repro_torch.models.config import ModelConfig

ENV_OVERRIDES = "REPRO_TORCH_CFG_OVERRIDES"

ARCH_IDS = [
    "zamba2-7b",
    "seamless-m4t-medium",
    "llama4-maverick-400b-a17b",
    "arctic-480b",
    "falcon-mamba-7b",
    "granite-34b",
    "gemma2-2b",
    "llama3.2-1b",
    "yi-6b",
    "internvl2-1b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _env_overrides() -> dict:
    """REPRO_TORCH_CFG_OVERRIDES="ssm_tp=false,ssm_chunk=512": fields of the
    full config replaced for an A/B run (the port's name for the reference's
    knob)."""
    raw = os.environ.get(ENV_OVERRIDES, "")
    out = {}
    for kv in filter(None, raw.split(",")):
        k, v = kv.split("=")
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = float(v)
    return out


def get_config(arch: str) -> ModelConfig:
    cfg = importlib.import_module(_MODULES[arch]).CONFIG
    ov = _env_overrides()
    return dataclasses.replace(cfg, **ov) if ov else cfg


def get_reduced(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).reduced()


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 500k context needs sub-quadratic attention"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
