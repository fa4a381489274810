"""The port's serving path (KV and SSM caches, prefill, greedy decode, the
engine, ``launch/serve.py``) against the reference on the CPU.

The reference's engine needs a mesh, so its side calls
``repro.models.model.forward`` with a cache directly (jitted once per shape)
and samples as its decode step does: ``vocab_pad_mask`` then argmax.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.obs import trace as otrace
from repro_torch.obs.metrics import get_registry
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from torch_lm_parity import as_torch, configs, inputs, params, ref_encode, ref_forward

PROMPT, NEW = 8, 8  # prompt tokens, greedy steps after the prefill's token


def _greedy(logits, vocab):
    return jnp.argmax(rlayers.vocab_pad_mask(logits.astype(jnp.float32), vocab), -1).astype(
        jnp.int32)


def _step_inputs(cfg, tok, rng):
    """The next decode step's input: the sampled token, or for an
    embeddings-fed model a fresh embedding row (what a frontend would send)."""
    if cfg.input_kind == "tokens":
        return {"tokens": np.asarray(tok)[:, None]}
    return {"embeds": rng.standard_normal((tok.shape[0], 1, cfg.d_model), dtype=np.float32)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_greedy_decode_match_the_reference(arch):
    """A PROMPT-token prefill into a cache of PROMPT + NEW, then NEW greedy
    steps: equal tokens, each step's logits within 5e-4; the port's engine
    samples the same tokens."""
    rcfg, tcfg = configs(arch)
    rp, tp = params(arch)
    B, T = 2, PROMPT + NEW
    x = inputs(tcfg, B, PROMPT, seed=11)
    r_enc = t_enc = None
    if tcfg.enc_layers:
        r_enc = ref_encode(rp, cfg=rcfg, enc_embeds=jnp.asarray(x["enc_embeds"]))
        t_enc = tmodel.encode(tp, tcfg, torch.from_numpy(x["enc_embeds"]))
    rc = rmodel.init_cache(rcfg, B, T)
    tc = tmodel.init_cache(tcfg, B, T, device="cpu")
    prefill = make_prefill_step(tcfg, device="cpu")
    decode = make_decode_step(tcfg, device="cpu")
    ec = tmodel.init_cache(tcfg, B, T, device="cpu")  # the engine's own cache

    first = {k: v for k, v in x.items() if k != "enc_embeds"}
    want, rc = ref_forward(rp, cfg=rcfg, cache=rc, enc_out=r_enc, last_only=True,
                           **{k: jnp.asarray(v) for k, v in first.items()})
    got, tc = tmodel.forward(tp, tcfg, cache=tc, enc_out=t_enc, last_only=True,
                             **as_torch(first))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)
    eng, ec = prefill(tp, dict(as_torch(first), enc_out=t_enc), ec)
    np.testing.assert_allclose(eng.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)

    tok = _greedy(want[:, -1], rcfg.vocab)
    assert np.array_equal(np.asarray(tok), torch.argmax(
        tlayers.vocab_pad_mask(got[:, -1], tcfg.vocab), -1).numpy())
    rng = np.random.default_rng(12)
    for t in range(PROMPT, PROMPT + NEW):
        step = _step_inputs(tcfg, tok, rng)
        want, rc = ref_forward(rp, cfg=rcfg, cache=rc, pos_offset=jnp.int32(t),
                               **{k: jnp.asarray(v) for k, v in step.items()})
        got, tc = tmodel.forward(tp, tcfg, cache=tc, pos_offset=t, **as_torch(step))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4,
                                   err_msg=f"step {t}")
        eng_tok, ec = decode(tp, as_torch(step), ec, t)
        tok = _greedy(want[:, -1], rcfg.vocab)
        assert eng_tok.dtype == torch.int32
        assert np.array_equal(eng_tok.numpy(), np.asarray(tok)), f"step {t}"
    for stage in tc:  # every attention cache advanced to the last position
        for slot in stage.get("slots", {"": stage.get("block")}).values():
            if "attn" in slot:
                assert slot["attn"]["pos"] == T


@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b", "falcon-mamba-7b"])
def test_full_prefill_fills_the_cache_as_the_reference(arch):
    """A prompt as long as the cache takes the full-prefill branch: the
    cache's K/V (stacked per period), SSM states and conv tails equal the
    reference's, and ``pos`` is the prompt length."""
    rcfg, tcfg = configs(arch)
    rp, tp = params(arch)
    B, S = 2, 16
    tok = inputs(tcfg, B, S, seed=13)["tokens"]
    want, rc = ref_forward(rp, cfg=rcfg, tokens=jnp.asarray(tok),
                           cache=rmodel.init_cache(rcfg, B, S), last_only=True)
    got, tc = tmodel.forward(tp, tcfg, torch.from_numpy(tok),
                             cache=tmodel.init_cache(tcfg, B, S, device="cpu"), last_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)
    flat_r = jax.tree_util.tree_flatten_with_path(rc)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tc)[0])
    assert len(flat_r) == len(flat_t)
    for path, want_leaf in flat_r:
        got_leaf = flat_t[path]
        if path[-1].key == "pos":
            assert int(got_leaf) == S and np.all(np.asarray(want_leaf) == S)
        else:
            np.testing.assert_allclose(got_leaf.numpy(), np.asarray(want_leaf), rtol=5e-4,
                                       atol=5e-4, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-7b"])
def test_decode_matches_full_forward(arch):
    """The reference's own property for the port alone: token-by-token
    decode from an empty cache equals one full forward."""
    _, tcfg = configs(arch)
    _, tp = params(arch)
    B, S = 2, 16
    tok = torch.from_numpy(inputs(tcfg, B, S, seed=14)["tokens"])
    full, _ = tmodel.forward(tp, tcfg, tok)
    cache = tmodel.init_cache(tcfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = tmodel.forward(tp, tcfg, tok[:, t:t + 1], cache=cache, pos_offset=t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=5e-4, atol=5e-4)


def test_engine_records_spans_and_counters(tmp_path):
    _, tcfg = configs("llama3.2-1b")
    _, tp = params("llama3.2-1b")
    reg = get_registry()
    n_pre, n_dec = reg.counter("serve.prefills").value, reg.counter("serve.decodes").value
    cache = tmodel.init_cache(tcfg, 2, 6, device="cpu")
    path = tmp_path / "trace.jsonl"
    with otrace.trace_to(str(path)):
        logits, cache = make_prefill_step(tcfg, device="cpu")(
            tp, {"tokens": torch.zeros((2, 4), dtype=torch.int32)}, cache)
        decode = make_decode_step(tcfg, device="cpu")
        for pos in (4, 5):
            tok, cache = decode(tp, {"tokens": torch.zeros((2, 1), dtype=torch.int32)}, cache,
                                pos)
    assert logits.shape == (2, 1, tcfg.padded_vocab) and tok.shape == (2,)
    assert reg.counter("serve.prefills").value == n_pre + 1
    assert reg.counter("serve.decodes").value == n_dec + 2
    spans = [json.loads(line) for line in path.read_text().splitlines()]
    spans = [s for s in spans if s.get("type") == "span"]
    assert [s["name"] for s in spans] == ["serve.prefill", "serve.decode", "serve.decode"]
    assert [s["attrs"].get("pos") for s in spans[1:]] == [4, 5]


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """No CPU fallback: without ``device`` the steps and the launcher ask
    for the card, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs("llama3.2-1b")
    for make in (make_prefill_step, make_decode_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_cache(tcfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.run("llama3.2-1b", quiet=True)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-medium", "zamba2-7b"])
def test_launch_serve_runs_on_the_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                        "--prompt-len", "16", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {arch} on cpu: (2, 4) tokens" in out
    toks = tserve.run(arch, batch=2, prompt_len=16, new_tokens=4, device="cpu", quiet=True)
    again = tserve.run(arch, batch=2, prompt_len=16, new_tokens=4, device="cpu", quiet=True)
    assert toks.dtype == torch.int32 and torch.equal(toks, again)  # seeded
    assert int(toks.min()) >= 0 and int(toks.max()) < configs(arch)[1].vocab


def test_launch_serve_module_entry_point():
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--new-tokens", "3"], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[serve] llama3.2-1b on cpu: (4, 3) tokens" in out.stdout


def test_serve_outputs_on_the_cpu():
    """The cross-check's CPU side: its logits are the forward's, its loss
    ``loss_fn``'s, and its tokens the engine's greedy decode."""
    from repro_torch.data import SyntheticLM
    from repro_torch.serve.crosscheck import serve_outputs

    _, tcfg = configs("seamless-m4t-medium")
    _, tp = params("seamless-m4t-medium")
    batch = SyntheticLM(tcfg, 2, 8).batch(0)
    out = serve_outputs(tcfg, tp, batch, device="cpu", steps=3)
    tb = as_torch(batch)
    enc = tmodel.encode(tp, tcfg, tb["enc_embeds"])
    assert torch.equal(out["encode"], enc)
    full, _ = tmodel.forward(tp, tcfg, tb["tokens"], enc_out=enc)
    assert torch.equal(out["logits"], full)
    assert torch.equal(out["loss"], tmodel.loss_fn(tp, tcfg, tb["tokens"], tb["labels"],
                                                   enc_embeds=tb["enc_embeds"]))
    assert out["tokens"].shape == (2, 4) and out["tokens"].dtype == torch.int32
    torch.testing.assert_close(out["prefill"][:, 0], full[:, -1], rtol=1e-6, atol=1e-6)
