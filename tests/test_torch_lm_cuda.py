"""The LM serving and training paths on the card against the same paths on
the CPU.

For every reduced config in float32, with one set of parameters and one
``SyntheticLM`` batch: the forward logits (and the encoder's output), the
loss, the prefill's logits within rel_err 1e-5 (``max|card - cpu| /
max|card|``, as ``chip_smoke.py`` measures it), and the prefill's token
plus 16 greedy decode steps equal; the loss's gradients (``remat`` on)
within 1e-5 of the tree's largest gradient. Then two ``make_train_step``
steps, and a checkpoint saved from the card and restored to it bit for
bit. The CPU tests hold the CPU path to the reference, so the card's
agreement carries over.

Every test needs a CUDA device and skips without one; on the GPU machine run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_lm_cuda.py``.
This file imports neither jax nor the reference package.
"""
import dataclasses

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.models import init_params
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.serve.crosscheck import serve_outputs
from repro_torch.train import adamw_init, make_train_step
from repro_torch.train.step import value_and_grad

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


def _f32(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32", param_dtype="float32")


def _tree_rel(card, cpu) -> float:
    big = max(float(t.abs().max()) for t in tree_leaves(cpu))
    return max(float((a.cpu() - b).abs().max()) for a, b in
               zip(tree_leaves(card), tree_leaves(cpu), strict=True)) / big


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grads_card_match_cpu(cuda_device, arch):
    cfg = _f32(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(cfg, 2, 32).batch(0).items()}
    loss, grads = value_and_grad(cfg, params, batch)
    on = tree_map(lambda t: t.to(cuda_device), params)
    l_card, g_card = value_and_grad(cfg, on, {k: v.to(cuda_device) for k, v in batch.items()})
    assert abs(float(l_card) - float(loss)) <= REL * abs(float(loss))
    assert _tree_rel(g_card, grads) <= REL


def test_train_steps_card_match_cpu(cuda_device):
    cfg = _f32("llama3.2-1b")
    data = SyntheticLM(cfg, 4, 32)
    runs = []
    for dev in (torch.device("cpu"), cuda_device):
        params = tree_map(lambda t: t.to(dev),
                          init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
        opt = adamw_init(params)
        step = make_train_step(cfg, dev, microbatches=2, peak_lr=1e-3, warmup=1)
        losses = [float(step(params, opt, data.batch(i), i)[2]["loss"]) for i in range(2)]
        runs.append((losses, params))
    (cpu_losses, cpu_params), (card_losses, card_params) = runs
    for a, b in zip(card_losses, cpu_losses):
        assert abs(a - b) <= REL * abs(b)
    assert _tree_rel(card_params, cpu_params) <= REL


def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    cfg = get_reduced("llama3.2-1b")  # bfloat16 parameters, float32 moments
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                         device=cuda_device)
    opt = adamw_init(params)
    step = make_train_step(cfg, cuda_device, warmup=0)
    params, opt, _ = step(params, opt, SyntheticLM(cfg, 2, 32).batch(0), 0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, params, opt, {"device": "cuda"})
    zeros = tree_map(torch.zeros_like, {"p": params, "o": opt})
    p, o, man = mgr.restore(mgr.latest_step(), zeros["p"], zeros["o"], device=cuda_device)
    for got, want in zip(tree_leaves([p, o]), tree_leaves([params, opt]), strict=True):
        assert got.device == want.device and got.dtype == want.dtype and torch.equal(got, want)
    assert man == {"step": 0, "device": "cuda"}
