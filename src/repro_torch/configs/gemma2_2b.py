"""gemma2-2b — alternating local(4k sliding)/global attention + logit softcaps.

[arXiv:2408.00118; hf] 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Pattern ``LA``: sliding-window layer then global layer; attention logits
soft-capped at 50, final logits at 30.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense", n_layers=26, d_model=2304, n_heads=8,
    n_kv=4, d_ff=9216, vocab=256000, head_dim=256, pattern="LA",
    sliding_window=4096, softcap=50.0, final_softcap=30.0, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256, sliding_window=16,
    )
