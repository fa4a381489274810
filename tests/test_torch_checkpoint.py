"""The port's checkpoint manager and training launcher on the CPU.

The on-disk format is the reference's, so checkpoints cross between the two
packages bit for bit in both directions (bfloat16 leaves included); the
commit is atomic, old steps are collected, and a run that stops after a
checkpoint resumes to the uninterrupted run's losses.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.checkpoint import CheckpointManager as RefManager
from repro.models import model as rmodel
from repro.train import optim as roptim
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models.convert import opt_state_from_reference, params_from_reference
from repro_torch.train import adamw_init

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"  # the reduced config in its own dtypes: bfloat16 parameters


def _tiny():
    params = {"w": torch.ones(4, 4), "h": torch.arange(6.0).to(torch.bfloat16)}
    return params, adamw_init(params)


def _equal(a, b) -> bool:
    """Bit equality of two trees of tensors."""
    la, lb = tmodel.tree_leaves(a), tmodel.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def test_atomic_commit_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    params, opt = _tiny()
    opt["m"]["w"].fill_(0.25)
    opt["step"].fill_(3)
    assert mgr.latest_step() is None
    mgr.save(3, params, opt, {"arch": "t"})
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_000000003"]
    os.makedirs(tmp_path / "step_000000007.tmp")  # a stale .tmp is never a committed step
    assert mgr.latest_step() == 3
    example = tmodel.tree_map(torch.zeros_like, {"p": params, "o": opt})
    p2, o2, man = mgr.restore(3, example["p"], example["o"], device="cpu")
    assert _equal(p2, params) and _equal(o2, opt) and man == {"step": 3, "arch": "t"}
    (tmp_path / "LATEST").write_text("9")  # LATEST naming a step that is not there
    assert mgr.latest_step() is None


def test_gc_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params, opt = _tiny()
    for s in (1, 2, 3, 4):
        mgr.save(s, params, opt)
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_000000003", "step_000000004"] and mgr.latest_step() == 4


@functools.lru_cache(maxsize=None)
def _reference_state():
    """The reference's reduced llama (bfloat16 parameters) and an AdamW state
    with moments that are not zero, as numpy trees."""
    cfg = rconfigs.get_reduced(ARCH)

    def make(key):
        params = rmodel.init_params(cfg, key)
        opt = roptim.adamw_init(params)
        grads = jax.tree.map(lambda p: jnp.cos(p.astype(jnp.float32)).astype(p.dtype), params)
        params, opt, _ = roptim.adamw_update(params, grads, opt, lr=1e-2)
        return params, opt

    params, opt = jax.jit(make)(jax.random.PRNGKey(1))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt)


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    rp, ropt = _reference_state()
    RefManager(str(tmp_path)).save(5, rp, ropt, {"arch": ARCH})
    cfg = tconfigs.get_reduced(ARCH)
    example = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 5
    p, o, man = mgr.restore(5, example, adamw_init(example))
    assert _equal(p, params_from_reference(cfg, rp))
    assert _equal(o, opt_state_from_reference(cfg, ropt))
    assert tmodel.tree_leaves(p)[0].dtype == torch.bfloat16 and man["arch"] == ARCH


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    rp, ropt = _reference_state()
    cfg = tconfigs.get_reduced(ARCH)
    tp, topt = params_from_reference(cfg, rp), opt_state_from_reference(cfg, ropt)
    CheckpointManager(str(tmp_path / "port")).save(5, tp, topt, {"arch": ARCH})
    RefManager(str(tmp_path / "ref")).save(5, rp, ropt, {"arch": ARCH})
    # the same files: keys, dtypes and values of both packages' npz
    for name in ("params.npz", "opt_state.npz"):
        with np.load(tmp_path / "port" / "step_000000005" / name) as a, \
                np.load(tmp_path / "ref" / "step_000000005" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)
    ref = RefManager(str(tmp_path / "port"))
    assert ref.latest_step() == 5
    zeros = jax.tree.map(jnp.zeros_like, (rp, ropt))
    p, o, man = ref.restore(5, *zeros)
    for got, want in ((p, rp), (o, ropt)):
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert x.dtype == y.dtype and np.asarray(x).tobytes() == np.asarray(y).tobytes()
    assert man == {"step": 5, "arch": ARCH}


def test_resume_gives_the_uninterrupted_losses(tmp_path):
    """Crash after step 9 + resume == the uninterrupted run (the reference's
    ``test_resume_is_bitwise_deterministic``; bit for bit on the CPU)."""
    kw = dict(ckpt_every=5, global_batch=2, seq_len=16, device="cpu", quiet=True)
    full = tlaunch.run(ARCH, steps=14, ckpt_dir=str(tmp_path / "a"), **kw)
    tlaunch.run(ARCH, steps=10, ckpt_dir=str(tmp_path / "b"), **kw)  # "crashes" after step 9
    resumed = tlaunch.run(ARCH, steps=14, ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(full) == 14 and len(resumed) == 4
    assert resumed == full[10:]
    np.testing.assert_allclose(resumed, full[10:], rtol=1e-5)
    with open(tmp_path / "b" / "step_000000009" / "manifest.json") as f:
        assert json.load(f) == {"step": 9, "arch": ARCH, "device": "cpu"}


@pytest.mark.parametrize("budget,flag", [(1e-9, True), (1e9, False)])
def test_heartbeat_straggler_flag(tmp_path, budget, flag):
    losses = tlaunch.run(ARCH, steps=2, global_batch=2, seq_len=16, ckpt_dir=str(tmp_path),
                         step_budget_s=budget, device="cpu", quiet=True)
    with open(tmp_path / "heartbeat.json") as f:
        beat = json.load(f)
    assert beat["step"] == 1 and beat["straggler"] is flag and beat["loss"] == losses[-1]


def test_train_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
                          "--device", "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "2"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "step    1 loss" in out.stdout and "on cpu" in out.stdout
    assert CheckpointManager(str(tmp_path)).latest_step() == 1
