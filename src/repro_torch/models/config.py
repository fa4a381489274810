"""Unified model configuration covering all 10 assigned architecture families.

The per-layer ``pattern`` string selects block kinds:
  ``A`` global attention + MLP          ``L`` sliding-window attention + MLP
  ``E`` attention + MoE FFN             ``D`` attention + dense MLP (in MoE archs)
  ``M`` Mamba1 block                    ``S`` Mamba2 (SSD) block
  ``H`` shared attention block (one param set reused at every H position — zamba2)
The pattern is cycled to ``n_layers``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    mlp_gated: bool = True  # SwiGLU (llama family) vs plain GELU (granite-style)
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    pattern: str = "A"
    sliding_window: int = 4096
    softcap: float = 0.0  # gemma2 attention logit soft-capping
    final_softcap: float = 0.0  # gemma2 final-logit soft-capping
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    moe_dense_ff: int = 0  # arctic: parallel dense-residual MLP width
    # --- SSM ---
    ssm_state: int = 0
    d_inner_mult: int = 2
    conv_kernel: int = 4
    mamba_headdim: int = 64
    ssm_chunk: int = 256  # chunked-scan chunk length (SSD blocking)
    # TP for SSM layers. False = fully data-parallel mamba blocks (batch over
    # pod×data×model, weights FSDP-gathered at use): trades a per-layer-pass
    # weight all-gather (~p bytes) for the Megatron activation all-reduce
    # (~B·S·d bytes) — a large win when activations >> per-layer params
    # (§Perf hillclimb 1).
    ssm_tp: bool = True
    # --- encoder (enc-dec archs only) ---
    enc_layers: int = 0
    enc_pattern: str = "A"
    enc_seq: int = 0  # encoder input length for dry-run specs
    # --- input modality ---
    input_kind: str = "tokens"  # tokens | embeddings (audio frames / vision patches)
    tie_embeddings: bool = True
    # Pad Q heads up to this count with zero-weight heads (exact: padded heads
    # have zero wo rows, so they contribute nothing and receive no gradient).
    # Restores head-sharded attention TP for archs whose head count doesn't
    # divide the model axis (llama4: 40->48) — §Perf hillclimb 3. 0 = off.
    head_pad_to: int = 0
    # --- numerics ---
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "bfloat16"
    # --- long-context applicability (sub-quadratic attention available?) ---
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 128, as in the reference (its layout).

        Pad logits are masked to -1e30 in the loss and sampling, so semantics
        are exact; only the embedding/head allocation grows.
        """
        return -(-self.vocab // 128) * 128

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        p = (self.pattern * (self.n_layers // len(self.pattern) + 1))[: self.n_layers]
        return tuple(p)

    @property
    def enc_layer_kinds(self) -> tuple[str, ...]:
        p = (self.enc_pattern * (self.enc_layers // len(self.enc_pattern) + 1))
        return tuple(p[: self.enc_layers])

    @property
    def d_inner(self) -> int:
        return self.d_inner_mult * self.d_model

    def segments(self, kinds: tuple[str, ...] | None = None) -> list[tuple[str, int]]:
        """Group consecutive identical layer kinds into scan segments."""
        kinds = kinds if kinds is not None else self.layer_kinds
        segs: list[tuple[str, int]] = []
        for k in kinds:
            if segs and segs[-1][0] == k:
                segs[-1] = (k, segs[-1][1] + 1)
            else:
                segs.append((k, 1))
        return segs
