"""arctic-480b — 128-expert top-2 MoE with parallel dense residual MLP.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000. Every layer: attention + (top-2 of 128 experts ∥
dense residual MLP), the arctic dense-MoE hybrid.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168, n_heads=56,
    n_kv=8, d_ff=4864, vocab=32000, head_dim=128, pattern="E", n_experts=128,
    top_k=2, moe_dense_ff=4864, tie_embeddings=False,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256, n_experts=4, moe_dense_ff=128,
    )
