"""The port's LM substrate (configs, data, parameters, the model's forward
and loss) against the reference on the CPU; its layers are held to the
reference's one by one in ``test_torch_lm_layers.py``.

Reduced configs switched to float32, as the reference's own model tests
do; inputs from a numpy seed; parameters are the reference's ``init_params``
copied into the port by ``models.convert.params_from_reference``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import pipeline as rdata
from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tdata
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_reference
from torch_lm_parity import KEY, as_torch, configs, params, ref_encode, ref_forward, ref_loss

ARCHS = rconfigs.ARCH_IDS
PROPERTIES = ("hd", "padded_vocab", "layer_kinds", "enc_layer_kinds", "d_inner")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------


def test_arch_registry_equal():
    assert tconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    assert tconfigs.all_cells() == rconfigs.all_cells()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_for_field(arch):
    for port, ref in ((tconfigs.get_config(arch), rconfigs.get_config(arch)),
                      (tconfigs.get_reduced(arch), rconfigs.get_reduced(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for prop in PROPERTIES:
            assert getattr(port, prop) == getattr(ref, prop), prop
        assert port.segments() == ref.segments()
        assert tmodel.build_stage_plan(port.pattern, port.layer_kinds) == [
            tmodel.StageSpec(**dataclasses.asdict(s))
            for s in rmodel.build_stage_plan(ref.pattern, ref.layer_kinds)]
    for shape in rconfigs.SHAPES:
        assert tconfigs.cell_applicable(arch, shape) == rconfigs.cell_applicable(arch, shape)


def test_config_overrides_use_the_ports_variable(monkeypatch):
    monkeypatch.setenv("REPRO_CFG_OVERRIDES", "ssm_tp=false,ssm_chunk=512,capacity_factor=1.5")
    monkeypatch.setenv(tconfigs.ENV_OVERRIDES, "ssm_tp=false,ssm_chunk=512,capacity_factor=1.5")
    assert tconfigs.ENV_OVERRIDES == "REPRO_TORCH_CFG_OVERRIDES"
    port, ref = tconfigs.get_config("zamba2-7b"), rconfigs.get_config("zamba2-7b")
    assert (port.ssm_tp, port.ssm_chunk, port.capacity_factor) == (False, 512, 1.5)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    monkeypatch.delenv(tconfigs.ENV_OVERRIDES)
    assert tconfigs.get_config("zamba2-7b").ssm_chunk == 256


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_of_the_full_config_equals_the_reference(arch):
    shapes = jax.eval_shape(lambda k: rmodel.init_params(rconfigs.get_config(arch), k), KEY)
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    meta = tmodel.init_params(tconfigs.get_config(arch), device="meta")
    assert tmodel.param_count(meta) == want
    # the same tree, leaf for leaf, dtypes included
    leaves = jax.tree.leaves(shapes)
    port = jax.tree.leaves(meta)  # both flattened in sorted-key order
    assert [tuple(s.shape) for s in leaves] == [tuple(t.shape) for t in port]
    assert [str(s.dtype) for s in leaves] == [str(t.dtype).removeprefix("torch.") for t in port]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-1b", "seamless-m4t-medium"])
@pytest.mark.parametrize("step", [0, 3])
def test_synthetic_batches_bit_identical(arch, step):
    cfg_t, cfg_r = tconfigs.get_reduced(arch), rconfigs.get_reduced(arch)
    for hosts in (1, 2):
        for h in range(hosts):
            got = tdata.SyntheticLM(cfg_t, 4, 16, seed=7).batch(step, host_index=h,
                                                                  host_count=hosts)
            want = rdata.SyntheticLM(cfg_r, 4, 16, seed=7).batch(step, host_index=h,
                                                                   host_count=hosts)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    cell = tdata.batch_for_cell(cfg_t, 8, 2, step)
    ref = rdata.batch_for_cell(cfg_r, 8, 2, step)
    assert all(np.array_equal(cell[k], ref[k]) for k in ref)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_the_reference(arch):
    """Logits (and the encoder's output) on ``SyntheticLM.batch(0)``, then
    the port's ``loss_fn`` on that batch against the reference's loss of
    those logits (its ``loss_fn`` is ``encode``, ``forward`` and
    ``cross_entropy`` in turn)."""
    rcfg, tcfg = configs(arch)
    rp, tp = params(arch)
    batch = tdata.SyntheticLM(tcfg, 2, 32).batch(0)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = as_torch(batch)
    r_enc = t_enc = None
    if tcfg.enc_layers:
        r_enc = ref_encode(rp, cfg=rcfg, enc_embeds=rb["enc_embeds"])
        t_enc = tmodel.encode(tp, tcfg, tb["enc_embeds"])
        _close(t_enc, r_enc, 2e-4)
    want, _ = ref_forward(rp, cfg=rcfg, tokens=rb.get("tokens"), embeds=rb.get("embeds"),
                          enc_out=r_enc)
    got, _ = tmodel.forward(tp, tcfg, tb.get("tokens"), embeds=tb.get("embeds"), enc_out=t_enc)
    assert got.shape == (2, 32, tcfg.padded_vocab) and got.dtype == torch.float32
    _close(got, want, 2e-4)
    # last_only is the last row of the full logits
    last, _ = tmodel.forward(tp, tcfg, tb.get("tokens"), embeds=tb.get("embeds"),
                             enc_out=t_enc, last_only=True)
    _close(last[:, 0], got[:, -1], 1e-6)
    want_loss = rlayers.cross_entropy(want, rb["labels"], rcfg.final_softcap,
                                      valid_vocab=rcfg.vocab)
    got_loss = tmodel.loss_fn(tp, tcfg, tb.get("tokens"), tb["labels"], embeds=tb.get("embeds"),
                              enc_embeds=tb.get("enc_embeds"))
    assert got_loss.shape == ()
    _close(got_loss, want_loss, 1e-4)


def test_loss_fn_matches_the_references_loss_fn():
    """The reference's ``loss_fn`` itself, on the soft-capped arch."""
    rcfg, tcfg = configs("gemma2-2b")
    rp, tp = params("gemma2-2b")
    batch = tdata.SyntheticLM(tcfg, 2, 32, seed=1).batch(2)
    want = ref_loss(rp, cfg=rcfg, tokens=jnp.asarray(batch["tokens"]),
                    labels=jnp.asarray(batch["labels"]), remat=False)
    tb = as_torch(batch)
    _close(tmodel.loss_fn(tp, tcfg, tb["tokens"], tb["labels"]), want, 1e-4)


def test_params_from_reference_checks_the_tree():
    rcfg, tcfg = configs("zamba2-7b")
    tree = jax.tree.map(np.asarray, rmodel.init_params(rcfg, KEY))
    tp = params_from_reference(tcfg, tree)
    # stacked slots and the one shared block, key for key
    stage = tp["stages"][0]
    assert sorted(stage["slots"]) == ["0", "1", "2", "3", "4"]
    assert sorted(stage["shared"]) == ["5"]
    assert stage["slots"]["0"]["mix"]["x_in"].shape[0] == 2
    np.testing.assert_array_equal(stage["shared"]["5"]["attn"]["wq"].numpy(),
                                  tree["stages"][0]["shared"]["5"]["attn"]["wq"])
    bad = jax.tree.map(lambda a: a, tree)
    bad["stages"][0]["shared"]["5"]["attn"]["wq"] = np.zeros((1, 2), np.float32)
    with pytest.raises(ValueError, match="wq"):
        params_from_reference(tcfg, bad)
    bad = dict(tree, extra=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(tcfg, bad)
    # bfloat16 leaves keep their bits
    rb = jax.tree.map(np.asarray, rmodel.init_params(rconfigs.get_reduced("llama3.2-1b"), KEY))
    tb = params_from_reference(tconfigs.get_reduced("llama3.2-1b"), rb)
    assert tb["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tb["embed"].float().numpy(), rb["embed"].astype(np.float32))


def test_own_init_is_seeded_and_shaped_as_the_reference():
    cfg = tconfigs.get_reduced("zamba2-7b")
    a = tmodel.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tmodel.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = tmodel.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    la, lb, lc = (tmodel.tree_leaves(t) for t in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(la[0], lc[0])
    ref = jax.eval_shape(lambda k: rmodel.init_params(rconfigs.get_reduced("zamba2-7b"), k), KEY)
    assert [tuple(s.shape) for s in jax.tree.leaves(ref)] == [
        tuple(t.shape) for t in jax.tree.leaves(a)]
