"""The port's LM layers (norms, rotary, loss, attention and its flash form,
MoE, Mamba1/2) against the reference's on the CPU, op by op.

Reduced configs switched to float32; inputs from a numpy seed; parameters
from the reference's initializers, as numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.obs.metrics import get_registry
from torch_lm_parity import KEY, configs, inputs


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_rotary_softcap_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 16), dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32) * 0.1
    _close(tlayers.rms_norm(_t(x), _t(scale), 1e-6), rlayers.rms_norm(x, scale, 1e-6), 2e-5)
    pos = np.arange(3, 12)
    for theta in (10000.0, 500000.0):
        _close(tlayers.rotary(_t(x), _t(pos), theta), rlayers.rotary(x, pos, theta), 2e-5)
    _close(tlayers.softcap(_t(x * 40), 30.0), rlayers.softcap(x * 40, 30.0), 2e-5)
    # bfloat16 in, bfloat16 out
    xb = torch.from_numpy(x).bfloat16()
    assert tlayers.rms_norm(xb, _t(scale), 1e-6).dtype == torch.bfloat16
    assert tlayers.rotary(xb, _t(pos), 1e4).dtype == torch.bfloat16


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("valid", [None, 250])
def test_cross_entropy_and_pad_mask_match(cap, valid):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 7, 256), dtype=np.float32) * 20
    labels = rng.integers(0, valid or 256, (2, 7), dtype=np.int32)
    got = tlayers.cross_entropy(_t(logits), _t(labels), cap, valid)
    want = rlayers.cross_entropy(logits, labels, cap, valid)
    _close(got, want, 2e-5)
    if valid:
        masked = tlayers.vocab_pad_mask(_t(logits), valid)
        assert np.array_equal(masked.numpy(), np.asarray(rlayers.vocab_pad_mask(logits, valid)))
        assert float(masked[..., valid:].max()) == float(np.float32(-1e30))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _plain_attention(q, k, v, *, causal, window, cap):
    """The non-flash path's arithmetic in numpy-fed torch (float32)."""
    hd = q.shape[-1]
    s = torch.einsum("bshd,bthd->bhst", q, k) * hd ** -0.5
    s = tlayers.softcap(s, cap)
    pos = torch.arange(q.shape[1])
    mask = tattn._mask(pos, pos, causal=causal, window=window)
    s = torch.where(mask[None, None], s, -1e30)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("window", [0, 700])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_flash_matches_plain_path_and_reference(window, cap):
    cfg_r = dataclasses.replace(rconfigs.get_reduced("gemma2-2b"), softcap=cap)
    cfg_t = dataclasses.replace(tconfigs.get_reduced("gemma2-2b"), softcap=cap)
    B, S, H, hd = 2, 2048, 4, 16
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((B, S, H, hd), dtype=np.float32) for _ in range(3))
    before = get_registry().counter("attention.flash").value
    got = tattn._flash(_t(q), _t(k), _t(v), cfg_t, causal=True, window=window, chunk=512)
    assert get_registry().counter("attention.flash").value == before + 1
    plain = _plain_attention(_t(q), _t(k), _t(v), causal=True, window=window, cap=cap)
    _close(got, plain, 2e-5)
    want = rattn._flash(q, k, v, cfg_r, causal=True, window=window, chunk=512,
                        differentiable=False)
    _close(got, want, 2e-5)


def test_flash_runs_from_the_threshold_in_forward(monkeypatch):
    """A forward over FLASH_THRESHOLD tokens takes ``_flash`` once per
    attention layer and agrees with the same forward on the plain path."""
    # one sliding-window and one global layer, soft-capped
    tcfg = dataclasses.replace(configs("gemma2-2b")[1], n_layers=2)
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    S = tattn.FLASH_THRESHOLD
    tok = _t(inputs(tcfg, 1, S, seed=3)["tokens"])
    before = get_registry().counter("attention.flash").value
    got, _ = tmodel.forward(tp, tcfg, tok, last_only=True)
    assert get_registry().counter("attention.flash").value == before + tcfg.n_layers
    monkeypatch.setattr(tattn, "FLASH_THRESHOLD", S + 1)
    plain, _ = tmodel.forward(tp, tcfg, tok, last_only=True)
    assert get_registry().counter("attention.flash").value == before + tcfg.n_layers
    _close(got, plain, 2e-5)


def test_repeat_kv_and_head_pad_mask():
    k = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(1, 1, 3, 8)
    kr = tattn._repeat_kv(k, 2)
    np.testing.assert_array_equal(kr.numpy(), np.repeat(k.numpy(), 2, axis=2))
    cfg_t = dataclasses.replace(tconfigs.get_config("llama4-maverick-400b-a17b"), head_pad_to=48)
    cfg_r = dataclasses.replace(rconfigs.get_config("llama4-maverick-400b-a17b"), head_pad_to=48)
    np.testing.assert_array_equal(tattn.head_pad_mask(cfg_t).numpy(),
                                  np.asarray(rattn.head_pad_mask(cfg_r)))
    assert tattn.head_pad_mask(tconfigs.get_config("llama3.2-1b")) is None


def test_head_padded_attention_matches():
    cfg_r = dataclasses.replace(configs("llama3.2-1b")[0], n_heads=6, n_kv=2, head_pad_to=8)
    cfg_t = dataclasses.replace(configs("llama3.2-1b")[1], n_heads=6, n_kv=2, head_pad_to=8)
    p = jax.tree.map(np.asarray, rattn.init_attn(KEY, cfg_r, jnp.float32))
    pt = {k: _t(v) for k, v in p.items()}
    x = np.random.default_rng(4).standard_normal((2, 12, cfg_r.d_model), dtype=np.float32)
    pos = np.arange(12)
    want, _ = rattn.attention(p, x, cfg_r, positions=pos)
    got, _ = tattn.attention(pt, _t(x), cfg_t, positions=_t(pos))
    _close(got, want, 2e-5)
    # the port's own init zeroes the same padded heads
    own = tattn.init_attn(tlayers.Init(torch.device("cpu"), torch.Generator().manual_seed(0)),
                          cfg_t, torch.float32)
    dead = (np.asarray(rattn.head_pad_mask(cfg_r)) == 0)
    assert not own["wq"][:, dead].any() and not own["wo"][dead].any()


# ---------------------------------------------------------------------------
# MoE and SSM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k,tokens", [(1, 16), (2, 16), (1, 8192)])
def test_moe_choices_then_output_match(top_k, tokens):
    """The router's choices first (``topk`` may break ties otherwise than
    ``lax.top_k``), then the output, no-drop and capacity paths."""
    rcfg, tcfg = (dataclasses.replace(c, top_k=top_k, capacity_factor=1.0)
                  for c in configs("arctic-480b"))
    p = jax.tree.map(np.asarray, rmoe.init_moe(KEY, rcfg, jnp.float32))
    pt = jax.tree.map(_t, p)
    x = np.random.default_rng(top_k).standard_normal((2, tokens // 2, rcfg.d_model),
                                                     dtype=np.float32)
    xt = x.reshape(-1, rcfg.d_model)
    r_gate, r_choice = jax.lax.top_k(jax.nn.softmax(xt @ p["router"], -1), top_k)
    gate, choice = tmoe.route(pt, _t(xt), tcfg)
    np.testing.assert_array_equal(choice.numpy(), np.asarray(r_choice))
    _close(gate / gate.sum(-1, keepdim=True), r_gate / r_gate.sum(-1, keepdims=True), 1e-5)
    assert tmoe.capacity(tcfg, tokens) == (tokens * top_k if tokens * top_k <= 4096
                                           else int(tokens * top_k / tcfg.n_experts))
    _close(tmoe.moe_ffn(pt, _t(x), tcfg), rmoe.moe_ffn(p, x, rcfg), 1e-4)


SSM = [("falcon-mamba-7b", "M", rssm.init_mamba1, rssm.mamba1, tssm.mamba1),
       ("zamba2-7b", "S", rssm.init_mamba2, rssm.mamba2, tssm.mamba2)]


@pytest.mark.parametrize("arch,kind,init,rfn,tfn", SSM)
@pytest.mark.parametrize("chunk", [8, 64])
def test_ssm_chunked_prefill_matches(arch, kind, init, rfn, tfn, chunk):
    rcfg, tcfg = (dataclasses.replace(c, ssm_chunk=chunk) for c in configs(arch))
    p = jax.tree.map(np.asarray, init(KEY, rcfg, jnp.float32))
    pt = jax.tree.map(_t, p)
    u = np.random.default_rng(5).standard_normal((2, 64, rcfg.d_model), dtype=np.float32)
    want, _ = rfn(p, u, rcfg)
    got, _ = tfn(pt, _t(u), tcfg)
    _close(got, want, 2e-4)
    # prefill into a cache: the carried state and conv tail
    rc = jax.tree.map(np.asarray, rmodel._block_cache(kind, rcfg, 2, 64, jnp.float32))
    tc = tmodel._block_cache(kind, tcfg, 2, 64, torch.float32, (), torch.device("cpu"))
    _, want_c = rfn(p, u, rcfg, rc)
    _, got_c = tfn(pt, _t(u), tcfg, tc)
    assert got_c.keys() == want_c.keys()
    for key in want_c:
        _close(got_c[key], want_c[key], 2e-4)


@pytest.mark.parametrize("arch,kind,init,rfn,tfn", SSM)
def test_ssm_decode_steps_match(arch, kind, init, rfn, tfn):
    rcfg, tcfg = (dataclasses.replace(c, ssm_chunk=8) for c in configs(arch))
    p = jax.tree.map(np.asarray, init(KEY, rcfg, jnp.float32))
    pt = jax.tree.map(_t, p)
    u = np.random.default_rng(6).standard_normal((2, 12, rcfg.d_model), dtype=np.float32)
    rc = jax.tree.map(np.asarray, rmodel._block_cache(kind, rcfg, 2, 12, jnp.float32))
    tc = tmodel._block_cache(kind, tcfg, 2, 12, torch.float32, (), torch.device("cpu"))
    _, rc = rfn(p, u[:, :8], rcfg, rc)  # an 8-token prefill, then single steps
    _, tc = tfn(pt, _t(u[:, :8]), tcfg, tc)
    for t in range(8, 12):
        want, rc = rfn(p, u[:, t:t + 1], rcfg, rc)
        got, tc = tfn(pt, _t(u[:, t:t + 1]), tcfg, tc)
        _close(got, want, 2e-4)
        for key in rc:
            _close(tc[key], rc[key], 2e-4)
