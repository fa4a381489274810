"""LM architecture zoo on tensors: dense/GQA, MoE, Mamba1/2, hybrid, enc-dec,
VLM/audio stubs (the port of the reference's ``repro.models``)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward, init_cache, init_params, param_count
