"""internvl2-1b — VLM: InternViT frontend (STUB) + qwen2-0.5b-class LM backbone.

[arXiv:2404.16821; hf] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The vision frontend is a stub per the assignment: ``input_specs`` provides
precomputed patch embeddings concatenated with token embeddings (B, S, d).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896, n_heads=14,
    n_kv=2, d_ff=4864, vocab=151655, head_dim=64, pattern="A",
    input_kind="embeddings", tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256,
    )
