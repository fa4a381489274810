"""falcon-mamba-7b — pure Mamba1 (attention-free) decoder.

[arXiv:2410.05355; unverified] 64L d_model=4096 d_ff=0 vocab=65024
ssm_state=16, d_inner=8192. Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv=1, d_ff=0, vocab=65024, pattern="M", ssm_state=16,
    d_inner_mult=2, subquadratic=True, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, vocab=256, ssm_state=8, ssm_chunk=16
    )
