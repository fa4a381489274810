"""Meta input builders for every (arch x shape cell x mesh).

Parameters, optimizer state, batch and cache come back as DTensors on the
``meta`` device, placed by the sharding rules on a ``DeviceMesh``, beside
their spec trees: the production layout with nothing allocated. A mesh of
256 or 512 ranks needs no card: start the default process group on the
``fake`` backend (``torch.testing._internal.distributed.fake_pg.FakeStore``).
"""
from __future__ import annotations

import os

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.meshutil import dp_axes as _dp_axes
from repro_torch.distributed.sharding import (
    SSM_WEIGHT_NAMES, batch_specs, cache_specs, param_specs, shard_tree,
)
from repro_torch.models import init_cache, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.train.optim import adamw_init

# archs whose optimizer state is kept in bf16 (the reference's choice, made
# for its accelerator's memory per device)
BF16_OPT = {"llama4-maverick-400b-a17b", "arctic-480b", "granite-34b"}

# train_4k gradient-accumulation microbatches: bounds per-device activation
# liveness (saved residuals scale with the local batch) for the big archs
TRAIN_MICROBATCHES = {
    "llama4-maverick-400b-a17b": 8,
    "arctic-480b": 8,
    "granite-34b": 4,
    "zamba2-7b": 2,
    "yi-6b": 2,
    "seamless-m4t-medium": 1,
}
ENV_MICROBATCHES = "REPRO_TORCH_MICROBATCHES"


def train_microbatches(arch: str) -> int:
    """Per-arch default; ``REPRO_TORCH_MICROBATCHES`` overrides it for A/B runs."""
    env = os.environ.get(ENV_MICROBATCHES)
    return int(env) if env else TRAIN_MICROBATCHES.get(arch, 1)


def _no_tp(cfg: ModelConfig) -> frozenset:
    return SSM_WEIGHT_NAMES if not cfg.ssm_tp else frozenset()


def abstract_params(cfg: ModelConfig, mesh, *, fsdp=True):
    """(meta parameter DTensors, their specs)."""
    params = init_params(cfg, device="meta")
    specs = param_specs(params, mesh, fsdp_axes=_dp_axes(mesh) if fsdp else (),
                        no_tp_names=_no_tp(cfg))
    return shard_tree(params, specs, mesh), specs


def abstract_opt(cfg: ModelConfig, params, mesh, *, fsdp=True):
    """(meta AdamW state DTensors for ``params``, their specs): moments in
    bf16 for ``BF16_OPT``, else float32; ``step`` replicated."""
    state_dtype = torch.bfloat16 if cfg.name in BF16_OPT else torch.float32
    opt = adamw_init(params, state_dtype=state_dtype)
    fsdp_axes = _dp_axes(mesh) if fsdp else ()
    specs = {
        "m": param_specs(opt["m"], mesh, fsdp_axes=fsdp_axes, no_tp_names=_no_tp(cfg)),
        "v": param_specs(opt["v"], mesh, fsdp_axes=fsdp_axes, no_tp_names=_no_tp(cfg)),
        "step": (),
    }
    return shard_tree(opt, specs, mesh), specs


def batch_shapes(cfg: ModelConfig, seq_len: int, global_batch: int, step: str) -> dict:
    """The meta batch of a shape cell (train/prefill take S tokens; decode 1)."""
    S = seq_len if step != "decode" else 1

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    b: dict = {}
    if cfg.input_kind == "tokens":
        b["tokens"] = meta((global_batch, S), torch.int32)
    else:
        b["embeds"] = meta((global_batch, S, cfg.d_model), torch.float32)
    if step == "train":
        b["labels"] = meta((global_batch, S), torch.int32)
        if cfg.enc_layers:
            b["enc_embeds"] = meta((global_batch, cfg.enc_seq, cfg.d_model), torch.float32)
    elif step == "prefill" and cfg.enc_layers:
        b["enc_out"] = meta((global_batch, cfg.enc_seq, cfg.d_model), torch.float32)
    return b


def input_specs(arch: str, shape: str, mesh) -> dict:
    """Every meta input of one cell on ``mesh`` (a ``DeviceMesh``): ``params``
    and ``batch``, with ``opt`` (train) or ``cache`` (prefill, decode), each
    beside its spec tree (``param_specs``, ...), and ``cfg``, ``cell``."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    dp = _dp_axes(mesh)
    out: dict = {"cfg": cfg, "cell": cell}
    out["params"], out["param_specs"] = abstract_params(cfg, mesh)
    batch = batch_shapes(cfg, cell.seq_len, cell.global_batch, cell.step)
    out["batch_specs"] = batch_specs(batch, mesh, dp_axes=dp)
    out["batch"] = shard_tree(batch, out["batch_specs"], mesh)
    if cell.step == "train":
        out["opt"], out["opt_specs"] = abstract_opt(cfg, out["params"], mesh)
    else:
        cache = init_cache(cfg, cell.global_batch, cell.seq_len, device="meta")
        out["cache_specs"] = cache_specs(cache, mesh, dp_axes=dp)
        out["cache"] = shard_tree(cache, out["cache_specs"], mesh)
    return out


def model_flops(cfg: ModelConfig, seq_len: int, global_batch: int, step: str) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (forward only), D = tokens."""
    n_active = active_param_count(cfg)
    tokens = global_batch * (seq_len if step != "decode" else 1)
    mult = 6.0 if step == "train" else 2.0
    return mult * n_active * tokens


def active_param_count(cfg: ModelConfig) -> float:
    """Per-token active parameters (MoE counts top_k experts, not all;
    norms are left out)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    n_mlp = d * f * (3 if cfg.mlp_gated else 2)
    n_attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv * hd * 2
    per_kind = {
        "A": n_attn + n_mlp, "L": n_attn + n_mlp, "H": n_attn + n_mlp,
        "D": n_attn + n_mlp,
        "C": 2 * n_attn + n_mlp,
        "E": n_attn + cfg.top_k * 3 * d * f + d * cfg.n_experts
        + (3 * d * cfg.moe_dense_ff if cfg.moe_dense_ff else 0),
        "M": 0, "S": 0,
    }
    if cfg.ssm_state:
        di = cfg.d_inner
        per_kind["M"] = d * 2 * di + di * d + di * (-(-d // 16) + 2 * cfg.ssm_state) \
            + (-(-d // 16)) * di
        nh = di // cfg.mamba_headdim
        per_kind["S"] = d * (2 * di + 2 * cfg.ssm_state + nh) + di * d
    total = sum(per_kind[k] for k in cfg.layer_kinds)
    total += sum(per_kind[k] for k in cfg.enc_layer_kinds)
    total += cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return float(total)
