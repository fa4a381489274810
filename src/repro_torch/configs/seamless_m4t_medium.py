"""seamless-m4t-medium — encoder-decoder multimodal (audio) transformer.

[arXiv:2308.11596; hf] 12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
Audio frontend is a STUB: ``input_specs`` feeds precomputed frame embeddings
to the encoder; the decoder consumes tokens with cross-attention.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=12, d_model=1024,
    n_heads=16, n_kv=16, d_ff=4096, vocab=256206, head_dim=64, pattern="C",
    enc_layers=12, enc_pattern="A", enc_seq=1536, input_kind="tokens",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=256, enc_layers=2, enc_seq=24,
    )
