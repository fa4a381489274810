"""The port's LM training path against the reference on the CPU.

Gradients of ``loss_fn`` for every reduced config (float32), with ``remat``
off and on, against ``jax.value_and_grad`` of the reference's; the
differentiable ``_flash`` against the reference's ``_flash(differentiable=
True)``; what ``remat`` and the checkpointed ``_flash`` keep for the
backward; AdamW and the cosine schedule; ``make_train_step`` with
microbatches and the bfloat16 gradient cast against the reference's
``make_train_step`` on a one-device host mesh; and the reference's
end-to-end loss-decrease check on the port.

Parameters come from the reference's ``init_params`` through
``convert.params_from_reference``. Gradient tolerances are relative to the
tree's largest gradient, never per leaf: llama4-maverick's router gradient
is zero in exact arithmetic (``top_k = 1`` renormalises its gate to 1), so
both sides hold rounding noise there.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch.mesh import make_host_mesh
from repro.models import attention as rattn
from repro.models import model as rmodel
from repro.train import optim as roptim
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLM
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.convert import opt_state_from_reference, params_from_reference
from repro_torch.obs.metrics import get_registry
from repro_torch.train import step as tstep
from repro_torch.train import adamw_init, adamw_update, cosine_schedule, make_train_step
from repro_torch.train.step import value_and_grad
from torch_lm_parity import as_torch, configs, params

ARCHS = rconfigs.ARCH_IDS
REL_LOSS = 1e-5
REL_GRAD = 1e-4  # of the tree's largest |gradient|


def _flat_ref(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree.detach().float().numpy()}
    out = {}
    for k, v in items:
        out.update(_flat_port(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _tree_rel(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    big = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / big


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch: str):
    """The reference's loss and gradients (``remat`` off: recomputation
    changes no value), compiled without XLA's backend optimizations, which
    on the CPU takes a fraction of the default compile."""
    rcfg, tcfg = configs(arch)
    rp, _ = params(arch)
    batch = SyntheticLM(tcfg, 2, 32).batch(0)

    def loss(p):
        return rmodel.loss_fn(p, rcfg, batch.get("tokens"), batch["labels"],
                              embeds=batch.get("embeds"), enc_embeds=batch.get("enc_embeds"),
                              remat=False)

    fn = jax.jit(jax.value_and_grad(loss)).lower(rp).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    value, grads = fn(rp)
    return float(value), _flat_ref(grads), batch


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    want_loss, want_grads, batch = _ref_value_and_grad(arch)
    _, tcfg = configs(arch)
    _, tp = params(arch)
    loss, grads = value_and_grad(tcfg, tp, as_torch(batch), remat=remat)
    assert abs(float(loss) - want_loss) <= REL_LOSS * abs(want_loss)
    assert _tree_rel(_flat_port(grads), want_grads) <= REL_GRAD
    assert all(p.grad is None and not p.requires_grad for p in tmodel.tree_leaves(tp))


# ---------------------------------------------------------------------------
# the differentiable _flash
# ---------------------------------------------------------------------------

FLASH_CASES = {"causal": (True, 0, 0.0), "window": (True, 12, 0.0),
               "softcap": (True, 0, 30.0), "bidirectional": (False, 0, 0.0)}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_grads_match_reference(case):
    causal, window, cap = FLASH_CASES[case]
    cfg_r = dataclasses.replace(rconfigs.get_reduced("gemma2-2b"), softcap=cap)
    cfg_t = dataclasses.replace(tconfigs.get_reduced("gemma2-2b"), softcap=cap)
    B, S, H, hd = 2, 32, 4, 16
    rng = np.random.default_rng(5)
    q, k, v, ct = (rng.standard_normal((B, S, H, hd), dtype=np.float32) for _ in range(4))
    want, vjp = jax.vjp(lambda q, k, v: rattn._flash(q, k, v, cfg_r, causal=causal, window=window,
                                                     chunk=8, differentiable=True), q, k, v)
    want_grads = vjp(ct)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = get_registry().counter("attention.flash").value
    got = tattn._flash(qt, kt, vt, cfg_t, causal=causal, window=window, chunk=8,
                       differentiable=True)
    got.backward(torch.from_numpy(ct))
    assert get_registry().counter("attention.flash").value == before + 1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for g, w in zip((qt.grad, kt.grad, vt.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def _saved_shapes(fn) -> list:
    """Shapes of the tensors autograd keeps for the backward of ``fn()``
    outside any checkpointed region (a checkpoint's own hook takes the
    tensors saved inside it)."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    out.sum().backward()
    return shapes


def test_differentiable_flash_keeps_no_probability_block():
    B, S, H, hd, chunk = 2, 32, 4, 16, 8
    cfg = tconfigs.get_reduced("llama3.2-1b")
    q, k, v = (torch.randn((B, S, H, hd), generator=torch.Generator().manual_seed(i))
               .requires_grad_() for i in range(3))
    block = (B, H, chunk, chunk)
    kept = _saved_shapes(lambda: tattn._flash(q, k, v, cfg, causal=True, window=0, chunk=chunk,
                                              differentiable=True))
    assert block not in kept and kept
    plain = _saved_shapes(lambda: tattn._flash(q, k, v, cfg, causal=True, window=0, chunk=chunk))
    assert block in plain  # the check can see a block where one is kept


def test_remat_keeps_no_layer_internals_and_counts_flash_once(monkeypatch):
    """Under ``remat`` the backward keeps no MLP hidden (B, S, d_ff) outside
    the recomputed units, and ``attention.flash`` counts forward calls only,
    not the backward's recomputations."""
    _, tcfg = configs("llama3.2-1b")
    _, tp = params("llama3.2-1b")
    B, S = 2, 32
    batch = as_torch(SyntheticLM(tcfg, B, S).batch(0))
    monkeypatch.setattr(tattn, "FLASH_THRESHOLD", S)  # every layer takes _flash
    hidden = (B, S, tcfg.d_ff)
    live = tmodel.tree_map(lambda t: t.detach().requires_grad_(), tp)
    flash = get_registry().counter("attention.flash")
    for remat in (True, False):
        before = flash.value
        kept = _saved_shapes(lambda: tmodel.loss_fn(live, tcfg, batch["tokens"], batch["labels"],
                                                     remat=remat))
        assert (hidden in kept) is not remat, remat
        assert flash.value - before == tcfg.n_layers, remat


# ---------------------------------------------------------------------------
# AdamW, the schedule, the train step
# ---------------------------------------------------------------------------


def test_cosine_schedule_matches_reference():
    for kw in (dict(peak_lr=3e-4, warmup=100, total=10000), dict(peak_lr=1e-3, warmup=0, total=50),
               dict(peak_lr=2e-3, warmup=10, total=40, floor=0.0)):
        for step in (0, 1, 5, 10, 11, 39, 40, 99, 100, 101, 5000, 10000, 20000):
            want = float(roptim.cosine_schedule(step, **kw))
            got = cosine_schedule(step, **kw)
            assert got.dtype == torch.float32 and got.shape == ()
            assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-12), (kw, step)


@pytest.mark.parametrize("clip", [0.05, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "b": (5,), "h": (3, 4)}
    p = {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
    p["h"] = p["h"].astype(jnp.bfloat16)  # a bfloat16 leaf
    g = {k: (0.3 * rng.standard_normal(s, dtype=np.float32)).astype(p[k].dtype)
         for k, s in shapes.items()}
    rp = jax.tree.map(jnp.asarray, p)
    ropt = roptim.adamw_init(rp)
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16 if k == "h"
                                                            else torch.float32)
          for k, v in p.items()}
    topt = adamw_init(tp)
    for i in range(3):  # moments and bias corrections past the first step
        rp, ropt, rnorm = roptim.adamw_update(rp, jax.tree.map(jnp.asarray, g), ropt, lr=1e-2,
                                              grad_clip=clip)
        tg = {k: torch.from_numpy(np.asarray(v, np.float32)).to(tp[k].dtype) for k, v in g.items()}
        out, topt, tnorm = adamw_update(tp, tg, topt, lr=1e-2, grad_clip=clip)
        assert out is tp and int(topt["step"]) == int(ropt["step"]) == i + 1
        assert abs(float(tnorm) - float(rnorm)) <= 1e-6 * float(rnorm)
    assert tp["h"].dtype == torch.bfloat16 and topt["m"]["h"].dtype == torch.float32
    for k in shapes:
        np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(rp[k], np.float32),
                                   rtol=1e-6, atol=1e-6)
        for mom in ("m", "v"):
            np.testing.assert_allclose(topt[mom][k].numpy(), np.asarray(ropt[mom][k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("microbatches,cast", [(1, None), (2, None), (2, "bfloat16")],
                         ids=["mb1", "mb2", "mb2-bf16-grads"])
def test_train_step_matches_reference(microbatches, cast):
    rcfg, tcfg = configs("llama3.2-1b")
    rp, tp = params("llama3.2-1b")
    kw = dict(microbatches=microbatches, peak_lr=1e-3, warmup=1, total_steps=20,
              grad_allreduce_dtype=cast)
    ref_step = jax.jit(ref_make_train_step(rcfg, make_host_mesh(1), **kw))
    port_step = make_train_step(tcfg, "cpu", **kw)
    ropt = roptim.adamw_init(rp)
    topt = opt_state_from_reference(tcfg, jax.tree.map(np.asarray, ropt))
    data = SyntheticLM(tcfg, 4, 16)
    with jax.default_matmul_precision("float32"):
        for step in range(3):
            rp, ropt, rm = ref_step(rp, ropt, data.batch(step), np.int32(step))
            tp, topt, tm = port_step(tp, topt, data.batch(step), step)
            for key in ("loss", "gnorm", "lr"):
                assert abs(float(tm[key]) - float(rm[key])) <= REL_LOSS * abs(float(rm[key])), key
    assert int(topt["step"]) == 3
    assert _tree_rel(_flat_port(tp), _flat_ref(rp)) <= REL_GRAD


def test_train_step_accumulates_in_the_gradients_dtype(monkeypatch):
    """bfloat16 parameters: the microbatch sum is kept in bfloat16, as the
    reference keeps it, and equals the per-microbatch gradients summed so."""
    cfg = tconfigs.get_reduced("llama3.2-1b")
    assert cfg.param_dtype == "bfloat16"
    p = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = as_torch(SyntheticLM(cfg, 4, 16).batch(0))
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()} for i in range(2)]
    want = tmodel.tree_map(torch.zeros_like, p)
    for half in halves:
        _, g = value_and_grad(cfg, p, half)
        for a, gi in zip(tmodel.tree_leaves(want), tmodel.tree_leaves(g)):
            assert gi.dtype == torch.bfloat16
            a.copy_(a + (gi / 2).to(a.dtype))
    seen = {}

    def spy(params, grads, state, *, lr):
        seen["grads"] = grads
        return params, state, torch.zeros(())

    monkeypatch.setattr(tstep, "adamw_update", spy)
    make_train_step(cfg, "cpu", microbatches=2)(p, adamw_init(p), batch, 0)
    for got, w in zip(tmodel.tree_leaves(seen["grads"]), tmodel.tree_leaves(want)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, w)


def test_end_to_end_training_loss_decreases():
    """The reference's ``test_end_to_end_training_loss_decreases`` on the
    port: 12 AdamW steps on a repeated batch memorise it."""
    cfg = dataclasses.replace(tconfigs.get_reduced("llama3.2-1b"), dtype="float32",
                              param_dtype="float32")
    p = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(p)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = []
    for _ in range(12):
        loss, g = value_and_grad(cfg, p, batch, remat=False)
        p, opt, _ = adamw_update(p, g, opt, lr=3e-3, weight_decay=0.0)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.5, losses
