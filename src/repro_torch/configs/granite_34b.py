"""granite-34b — deep MQA code model (GPT-BigCode style, non-gated GELU MLP).

[arXiv:2405.04324; hf] 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense", n_layers=88, d_model=6144, n_heads=48,
    n_kv=1, d_ff=24576, vocab=49152, head_dim=128, pattern="A",
    mlp_gated=False, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv=1, head_dim=16,
        d_ff=128, vocab=256,
    )
