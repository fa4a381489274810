"""llama4-maverick-400b-a17b — interleaved-MoE decoder, early fusion.

[hf:meta-llama/Llama-4-*; unverified] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1. Pattern ``DE``: alternating
dense / MoE FFN layers (llama4's interleaved MoE) — total ≈395B params,
≈17B active per token, matching the 400b-a17b name.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv=8, d_ff=8192, vocab=202048, head_dim=128, pattern="DE",
    n_experts=128, top_k=1, rope_theta=500000.0, tie_embeddings=False,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256, n_experts=4,
    )
