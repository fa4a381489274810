"""llama3.2-1b — small llama3 dense decoder.

[hf:meta-llama/Llama-3.2-1B; unverified] 16L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=128256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense", n_layers=16, d_model=2048, n_heads=32,
    n_kv=8, d_ff=8192, vocab=128256, head_dim=64, pattern="A",
    rope_theta=500000.0, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256,
    )
