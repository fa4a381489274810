"""The LM serving path on the card against the same path on the CPU.

For every reduced config in float32, with one set of parameters and one
``SyntheticLM`` batch: the forward logits (and the encoder's output), the
loss, the prefill's logits within rel_err 1e-5 (``max|card - cpu| /
max|card|``, as ``chip_smoke.py`` measures it), and the prefill's token
plus 16 greedy decode steps equal. The CPU tests hold the CPU path to the
reference, so the card's agreement carries over.

Every test needs a CUDA device and skips without one; on the GPU machine run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_lm_cuda.py``.
This file imports neither jax nor the reference package.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.models import init_params
from repro_torch.serve.crosscheck import serve_outputs

pytestmark = pytest.mark.cuda

REL = 1e-5
STEPS = 16


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs; skips on a machine without one.
    TF32 is off for the test so float32 products stay float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m cuda "
                    "tests/test_torch_lm_cuda.py` on the GPU machine")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _rel(x, ref) -> float:
    return float((x - ref).abs().max() / x.abs().max())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_card_matches_cpu(cuda_device, arch):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", param_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = SyntheticLM(cfg, 2, 32).batch(0)
    cpu = serve_outputs(cfg, params, batch, device="cpu", steps=STEPS)
    card = serve_outputs(cfg, params, batch, device=cuda_device, steps=STEPS)
    for key in ("logits", "prefill", "encode"):
        if cpu[key] is not None:
            assert _rel(card[key], cpu[key]) <= REL, key
    assert abs(float(card["loss"]) - float(cpu["loss"])) <= REL * abs(float(cpu["loss"]))
    assert card["tokens"].shape == (2, STEPS + 1)
    assert torch.equal(card["tokens"], cpu["tokens"])
