"""The LM steps on a mesh: ``repro_torch.distributed.constraints`` and the
mesh arguments of ``make_train_step``, ``make_prefill_step``,
``make_decode_step`` and the launchers, on the CPU.

* ``constrain``'s tag rule is held to the reference's own ``constrain``: the
  reference runs against a shape-only mesh (its ``compat.get_mesh``
  patched) and the ``PartitionSpec`` it hands to
  ``with_sharding_constraint`` is captured, for every tag at divisible and
  non-divisible dims on 2x2, 16x16 and 2x16x16 meshes.
* A one-rank gloo world in this process (a ``(1, 1)`` mesh, started and
  destroyed inside each test): one train step of every reduced config, a
  microbatched step, prefill and decode, the launchers, against the port's
  steps with no mesh.
* A 2x2 mesh on four forked gloo ranks, one group for the file (this file
  run as a script, started when the module starts): the reference's
  ``tests/test_multidevice.py`` mesh tests (train steps; prefill into a
  larger cache and decode) held to the port's one-device steps, with both
  sharding knobs.

The port's one-device steps are held to the reference in
``tests/test_torch_lm_train.py`` and ``tests/test_torch_lm_serve.py``, so
mesh ~ port one-device ~ reference.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
RANKS = 4
TOL = 1e-5
ARCHS = ("zamba2-7b", "seamless-m4t-medium", "llama4-maverick-400b-a17b", "arctic-480b",
         "falcon-mamba-7b", "granite-34b", "gemma2-2b", "llama3.2-1b", "yi-6b",
         "internvl2-1b")


def config(arch: str, **over):
    from repro_torch import configs

    return dataclasses.replace(configs.get_reduced(arch), dtype="float32",
                               param_dtype="float32", **over)


def copy(tree):
    from repro_torch.models.model import tree_map

    return tree_map(lambda t: t.clone(), tree)


def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def rel(a, b) -> float:
    a, b = float(whole(a)), float(whole(b))
    return abs(a - b) / max(abs(b), 1e-30)


def tree_err(a, b) -> float:
    """Largest difference of two trees over the largest magnitude in ``b``."""
    from repro_torch.models.model import tree_leaves

    la, lb = [whole(t) for t in tree_leaves(a)], [whole(t) for t in tree_leaves(b)]
    top = max(t.abs().max().item() for t in lb)
    return max((x - y).abs().max().item() for x, y in zip(la, lb, strict=True)) / top


def placed_as_specs(tree, specs, mesh) -> bool:
    """Every DTensor leaf's placements equal those of its spec."""
    from repro_torch.distributed.sharding import placements

    if isinstance(tree, dict):
        return all(placed_as_specs(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, list):
        return all(placed_as_specs(v, s, mesh) for v, s in zip(tree, specs, strict=True))
    if not isinstance(tree, torch.Tensor):
        return specs is None
    return list(tree.placements) == placements(specs, mesh)


def train_pair(cfg, mesh, *, steps: int, batch: int, seq: int, fsdp: bool = False,
               microbatches: int = 1):
    """``steps`` train steps with no mesh and on ``mesh`` from the same
    parameters and data: (per-step (loss, gnorm) pairs, final trees and the
    mesh step's specs inputs)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train import adamw_init, make_train_step

    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(params)
    data = SyntheticLM(cfg, batch, seq)
    one = make_train_step(cfg, "cpu", microbatches=microbatches)
    on_mesh = make_train_step(cfg, mesh=mesh, fsdp=fsdp, microbatches=microbatches,
                              example_params=params, example_opt=opt,
                              example_batch=data.batch(0))
    p0, o0, p1, o1 = copy(params), copy(opt), copy(params), copy(opt)
    metrics = []
    for s in range(steps):
        p0, o0, m0 = one(p0, o0, data.batch(s), s)
        p1, o1, m1 = on_mesh(p1, o1, data.batch(s), s)
        metrics.append((m0, m1))
    return metrics, (p0, o0), (p1, o1), (params, opt)


def grad_pair(cfg, mesh, *, batch: int, seq: int):
    """``(loss, gradients)`` of one batch with no mesh and on ``mesh``
    (parameters and batch placed by the rules, under ``set_mesh``). AdamW's
    first steps normalise each gradient entry, so parameters after a step
    say little about the gradients: they are compared here."""
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.meshutil import set_mesh
    from repro_torch.distributed.sharding import (
        SSM_WEIGHT_NAMES, batch_specs, param_specs, shard_tree,
    )
    from repro_torch.models import init_params
    from repro_torch.train.step import value_and_grad

    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    data = {k: torch.as_tensor(v) for k, v in SyntheticLM(cfg, batch, seq).batch(0).items()}
    one = value_and_grad(cfg, params, data)
    no_tp = frozenset() if cfg.ssm_tp else SSM_WEIGHT_NAMES
    placed = shard_tree(params, param_specs(params, mesh, no_tp_names=no_tp), mesh)
    with set_mesh(mesh):
        on_mesh = value_and_grad(cfg, placed, shard_tree(
            data, batch_specs(data, mesh, dp_axes=("data",)), mesh))
    return one, on_mesh


def serve_pair(cfg, mesh, *, batch: int, prompt: int, extra: int, decodes: int):
    """Greedy tokens (batch, 1 + decodes) with no mesh and on ``mesh``, and
    the mesh's final cache."""
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt), dtype=np.int32))
    out, caches = [], []
    for m in (None, mesh):
        cache = init_cache(cfg, batch, prompt + extra, device="cpu")
        kw = {} if m is None else dict(mesh=m, example_params=params, example_cache=cache,
                                       example_batch={"tokens": prompts})
        prefill, decode = (make_prefill_step(cfg, "cpu", **kw),
                           make_decode_step(cfg, "cpu", **kw))
        logits, cache = prefill(params, {"tokens": prompts}, cache)
        tok = torch.argmax(whole(logits)[:, -1, :cfg.vocab], dim=-1).to(torch.int32)
        toks = [tok]
        for t in range(decodes):
            tok, cache = decode(params, {"tokens": whole(tok)[:, None]}, cache, prompt + t)
            toks.append(whole(tok))
        out.append(torch.stack(toks, dim=1))
        caches.append(cache)
    return out[0], out[1], caches[1], params


# ---------------------------------------------------------------------------
# the rule against the reference's constrain
# ---------------------------------------------------------------------------


class FakeMesh:
    """Shape-only mesh (the reference's own stand-in, ``tests/test_sharding.py``)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


RULE_MESHES = {
    "2x2": {"data": 2, "model": 2},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
DIMS = (1, 2, 3, 4, 6, 16, 24, 32, 48, 256, 384, 512, 768, 1024)
TAGS = ("dp", "dpm", "model", None)


@pytest.mark.parametrize("tag", TAGS, ids=str)
@pytest.mark.parametrize("mesh_kind", RULE_MESHES)
def test_constrain_rule_matches_reference(mesh_kind, tag, monkeypatch):
    import jax
    from repro.distributed import constraints as rcon
    from repro_torch.distributed.constraints import tag_spec

    mesh = FakeMesh(RULE_MESHES[mesh_kind])
    seen = []
    monkeypatch.setattr(rcon.compat, "get_mesh", lambda: mesh)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    rng = np.random.default_rng([list(RULE_MESHES).index(mesh_kind), TAGS.index(tag)])
    cases = [((d,), (tag,)) for d in DIMS]
    for _ in range(24):  # this tag beside random others, in random shapes
        nd = int(rng.integers(2, 6))
        shape = tuple(int(d) for d in rng.choice(DIMS, nd))
        tags = [TAGS[int(i)] for i in rng.integers(0, 4, nd)]
        tags[int(rng.integers(0, nd))] = tag
        cases.append((shape, tuple(tags)))
    for shape, tags in cases:
        rcon.constrain(np.broadcast_to(np.float32(0), shape), *tags)  # no memory
        assert tag_spec(shape, tags, mesh) == seen[-1], (mesh_kind, shape, tags)
    assert len(seen) == len(cases)


def test_constrain_is_a_no_op_without_a_model_axis_and_loud_on_plain_tensors():
    from repro_torch.distributed.constraints import constrain
    from repro_torch.distributed.meshutil import get_mesh, set_mesh

    x = torch.zeros(4, 6)
    assert get_mesh() is None and constrain(x, "dp", None) is x
    with set_mesh(FakeMesh({"data": 4})):  # no "model" axis
        assert constrain(x, "dp", None) is x
    with set_mesh(FakeMesh({"data": 2, "model": 2})):
        with pytest.raises(TypeError, match=r"plain tensor of shape \(4, 6\).*'dp'"):
            constrain(x, "dp", "model")
        with pytest.raises(ValueError, match="tags"):
            constrain(x, "dp")
    assert get_mesh() is None


# ---------------------------------------------------------------------------
# a one-rank world in this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its tensors are tiny and
    DTensor's dispatch is serial, so more threads only contend with the
    forked ranks and the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    from repro_torch.distributed import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


TRAIN_CASES = [(a, {}) for a in ARCHS] + [("falcon-mamba-7b", {"ssm_tp": False})]


@pytest.mark.parametrize("arch,over", TRAIN_CASES,
                         ids=[a + ("-no-ssm-tp" if o else "") for a, o in TRAIN_CASES])
def test_train_step_on_one_rank_mesh(arch, over, tmp_path):
    from repro_torch.distributed.sharding import param_specs, SSM_WEIGHT_NAMES

    cfg = config(arch, **over)
    with one_rank_mesh(tmp_path) as mesh:
        metrics, (p0, _), (p1, o1), (params, _) = train_pair(cfg, mesh, steps=1, batch=2,
                                                             seq=16)
        (m0, m1), = metrics
        assert rel(m1["loss"], m0["loss"]) <= TOL and rel(m1["gnorm"], m0["gnorm"]) <= TOL
        assert all(list(v.placements) == [Replicate()] * 2 for v in m1.values())
        assert tree_err(p1, p0) <= TOL
        no_tp = frozenset() if cfg.ssm_tp else SSM_WEIGHT_NAMES
        specs = param_specs(params, mesh, no_tp_names=no_tp)
        assert placed_as_specs(p1, specs, mesh) and placed_as_specs(o1["m"], specs, mesh)


def test_microbatched_train_step_on_one_rank_mesh(tmp_path):
    cfg = config("llama3.2-1b")
    with one_rank_mesh(tmp_path) as mesh:
        metrics, (p0, _), (p1, _), _ = train_pair(cfg, mesh, steps=2, batch=4, seq=16,
                                                  microbatches=2)
        for m0, m1 in metrics:
            assert rel(m1["loss"], m0["loss"]) <= TOL and rel(m1["gnorm"], m0["gnorm"]) <= TOL
        assert tree_err(p1, p0) <= TOL


SERVE_CASES = {"llama3.2-1b": {}, "llama4-maverick-400b-a17b": {},
               "falcon-mamba-7b": {"ssm_tp": False}}


@pytest.mark.parametrize("arch", SERVE_CASES)
def test_serve_on_one_rank_mesh(arch, tmp_path):
    from repro_torch.distributed.sharding import cache_specs

    cfg = config(arch, **SERVE_CASES[arch])
    with one_rank_mesh(tmp_path) as mesh:
        t0, t1, cache, _ = serve_pair(cfg, mesh, batch=2, prompt=8, extra=4, decodes=2)
        assert torch.equal(t0, t1)
        specs = cache_specs(cache, mesh, dp_axes=("data",))
        assert placed_as_specs(cache, specs, mesh)


def test_bare_step_and_donation_on_one_rank_mesh(tmp_path):
    """With a mesh and no examples the step is bare (the caller places and
    sets the mesh); ``donate=False`` leaves the caller's trees as they were."""
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.meshutil import set_mesh
    from repro_torch.distributed.sharding import batch_specs, param_specs, shard_tree
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_leaves
    from repro_torch.train import adamw_init, make_train_step

    cfg = config("llama3.2-1b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(params)
    batch = SyntheticLM(cfg, 2, 16).batch(0)
    _, _, m0 = make_train_step(cfg, "cpu")(copy(params), copy(opt), batch, 0)
    with one_rank_mesh(tmp_path) as mesh:
        specs = param_specs(params, mesh)
        p = shard_tree(copy(params), specs, mesh)
        o = shard_tree(copy(opt), {"m": specs, "v": specs, "step": ()}, mesh)
        b = shard_tree(batch, batch_specs(batch, mesh, dp_axes=("data",)), mesh)
        with set_mesh(mesh):
            _, _, m1 = make_train_step(cfg, mesh=mesh)(p, o, b, 0)
        assert rel(m1["loss"], m0["loss"]) <= TOL
        keep, keep_opt = copy(params), copy(opt)
        step = make_train_step(cfg, mesh=mesh, example_params=params, example_opt=opt,
                               example_batch=batch, donate=False)
        step(params, opt, batch, 0)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params) + tree_leaves(opt),
                                                     tree_leaves(keep) + tree_leaves(keep_opt)))


def test_launchers_on_one_rank_mesh(tmp_path):
    from repro_torch.launch import serve as lserve, train as ltrain

    kw = dict(steps=2, global_batch=2, seq_len=8, quiet=True)
    one = ltrain.run("llama3.2-1b", device="cpu", **kw)
    with one_rank_mesh(tmp_path) as mesh:
        on_mesh = ltrain.run("llama3.2-1b", mesh=mesh, ckpt_dir=str(tmp_path / "ck"),
                             ckpt_every=2, **kw)
        assert on_mesh == one
        assert os.path.isdir(tmp_path / "ck") and os.listdir(tmp_path / "ck")
        skw = dict(batch=2, prompt_len=8, new_tokens=3, quiet=True)
        assert torch.equal(lserve.run("llama3.2-1b", mesh=mesh, **skw),
                           lserve.run("llama3.2-1b", device="cpu", **skw))


def test_production_mesh_needs_its_world():
    from repro_torch.launch import train as ltrain

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        ltrain.main(["--arch", "llama3.2-1b", "--device", "cpu", "--production-mesh",
                     "--steps", "1"])


# ---------------------------------------------------------------------------
# a 2x2 mesh on four forked gloo ranks (this file run as a script)
# ---------------------------------------------------------------------------


# the SSM paths' gradients on the 2x2 mesh: TP ("dp", "model") over two
# chunks, so the carried state meets the next chunk, and "dpm" (no SSM
# TP); zamba2's SSD blocks run on a 2x2 mesh in chip_smoke.py's phase 18a
MORE_2X2 = {"falcon-mamba-7b": {}, "falcon-mamba-7b/no-ssm-tp": {"ssm_tp": False}}
# the attention and MLP path's gradients on the 2x2 mesh, leaf by leaf
ATTN_2X2 = {"llama3.2-1b": {}}


def _rank(rank: int, D: int, out: str) -> None:
    import functools

    from repro_torch.distributed import make_mesh, sharding
    from repro_torch.distributed.sharding import SSM_WEIGHT_NAMES, cache_specs
    from repro_torch.train import step as tstep

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rendezvous"),
                            rank=rank, world_size=D)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    report = {}
    cfg = config("llama3.2-1b")
    for fsdp in (False, True):
        # FSDP shards leaves of 2**24 elements and more: the reduced config
        # has none, so the step's rules here shard every leaf they can
        param_specs = functools.partial(sharding.param_specs,
                                        fsdp_min_size=1 if fsdp else 1 << 24)
        tstep.param_specs = param_specs
        metrics, (p0, _), (p1, o1), (params, _) = train_pair(cfg, mesh, steps=3, batch=4,
                                                             seq=16, fsdp=fsdp)
        no_tp = frozenset() if cfg.ssm_tp else SSM_WEIGHT_NAMES
        specs = param_specs(params, mesh, fsdp_axes=("data",) if fsdp else (),
                            no_tp_names=no_tp)
        report[f"train/fsdp={fsdp}"] = {
            "loss": [rel(m1["loss"], m0["loss"]) for m0, m1 in metrics],
            "gnorm": [rel(m1["gnorm"], m0["gnorm"]) for m0, m1 in metrics],
            "params": tree_err(p1, p0),
            "placed": placed_as_specs(p1, specs, mesh) and all(
                placed_as_specs(o1[k], specs, mesh) for k in ("m", "v")),
        }
    tstep.param_specs = sharding.param_specs
    for run, over in {**ATTN_2X2, **MORE_2X2}.items():
        (l0, g0), (l1, g1) = grad_pair(config(run.split("/")[0], **over), mesh, batch=4,
                                       seq=32)
        report[f"grads/{run}"] = {"loss": rel(l1, l0), "grads": tree_err(g1, g0)}
    for knob, arch in (("REPRO_TORCH_DECODE_SP", "llama3.2-1b"),
                       ("REPRO_TORCH_MOE_DECODE_WS", "llama4-maverick-400b-a17b")):
        for value in ("0", "1"):
            os.environ[knob] = value
            tok0, tok1, cache, _ = serve_pair(config(arch), mesh, batch=4, prompt=8, extra=8,
                                              decodes=3)
            report[f"serve/{knob}={value}"] = {
                "tokens_equal": bool(torch.equal(tok0, tok1)),
                "placed": placed_as_specs(cache, cache_specs(cache, mesh, dp_axes=("data",)),
                                          mesh),
            }
        del os.environ[knob]
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def _main(out: str) -> None:
    import repro_torch.serve.engine  # noqa: F401  (imported once, before the fork)
    import repro_torch.train.step  # noqa: F401
    from torch_parity import fork_ranks

    fork_ranks(_rank, RANKS, (out,))


@pytest.fixture(scope="module", autouse=True)
def four_ranks(tmp_path_factory):
    """Start the four ranks when the module starts; the 2x2 tests wait."""
    out = tmp_path_factory.mktemp("mesh2x2")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([SRC, HERE, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    state = {}

    def reports():
        if "ranks" not in state:
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log[-4000:]
            state["ranks"] = [json.load(open(out / f"rank{r}.json")) for r in range(RANKS)]
        return state["ranks"]

    yield reports
    if proc.poll() is None:
        proc.kill()


@pytest.mark.parametrize("run", MORE_2X2)
def test_ssm_gradients_on_2x2_mesh(four_ranks, run):
    for rank, rep in enumerate(four_ranks()):
        r = rep[f"grads/{run}"]
        assert r["loss"] <= TOL and r["grads"] <= TOL, (rank, r)


@pytest.mark.parametrize("run", ATTN_2X2)
def test_attention_gradients_on_2x2_mesh(four_ranks, run):
    for rank, rep in enumerate(four_ranks()):
        r = rep[f"grads/{run}"]
        assert r["loss"] <= TOL and r["grads"] <= TOL, (rank, r)


@pytest.mark.parametrize("fsdp", [False, True], ids=["fsdp-off", "fsdp-on"])
def test_train_steps_on_2x2_mesh(four_ranks, fsdp):
    for rank, rep in enumerate(four_ranks()):
        r = rep[f"train/fsdp={fsdp}"]
        assert max(r["loss"]) <= TOL and max(r["gnorm"]) <= TOL, (rank, r)
        assert r["params"] <= TOL, (rank, r)
        assert r["placed"], rank


@pytest.mark.parametrize("value", ["0", "1"])
@pytest.mark.parametrize("knob", ["REPRO_TORCH_DECODE_SP", "REPRO_TORCH_MOE_DECODE_WS"])
def test_prefill_and_decode_on_2x2_mesh(four_ranks, knob, value):
    for rank, rep in enumerate(four_ranks()):
        r = rep[f"serve/{knob}={value}"]
        assert r["tokens_equal"] and r["placed"], (rank, r)


if __name__ == "__main__":
    _main(sys.argv[1])
