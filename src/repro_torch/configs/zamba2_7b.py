"""zamba2-7b — hybrid Mamba2 backbone + shared attention block.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000 ssm_state=64. Pattern: five Mamba2 (SSD) blocks then the SHARED
attention+MLP block (one parameter set reused at every ``H`` position).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv=32, d_ff=14336, vocab=32000, head_dim=112, pattern="SSSSSH",
    ssm_state=64, mamba_headdim=64, subquadratic=True, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=12, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=256, ssm_state=8, mamba_headdim=16, ssm_chunk=16,
    )
