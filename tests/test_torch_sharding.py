"""The port's sharding layer (``repro_torch.distributed``,
``repro_torch.launch.{mesh,specs}``) against the reference's
``repro.distributed`` and ``repro.launch.specs``.

Specs are held to the reference's ``PartitionSpec``s leaf for leaf for all
ten full configs on shape-only production meshes (no process group). The
DTensor placements run on fake worlds of 256 and 512 ranks (torch's
``fake`` backend: one process, no communication), each started and torn
down inside its test, so no process group outlives it.
"""
import contextlib
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro import configs as rconfigs
from repro.distributed import meshutil as rmeshutil
from repro.distributed import sharding as rsh
from repro.launch import specs as rspecs
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.train.optim import adamw_init as ref_adamw_init
from repro_torch import configs as tconfigs
from repro_torch.distributed import meshutil, sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import init_cache, init_params

ARCHS = tconfigs.ARCH_IDS
SSM_NO_TP = ("zamba2-7b", "falcon-mamba-7b")


class FakeMesh:
    """Shape-only stand-in so spec tests don't need 256 devices (the
    reference's own, ``tests/test_sharding.py``)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "single": FakeMesh({"data": 16, "model": 16}),
    "multi": FakeMesh({"pod": 2, "data": 16, "model": 16}),
}
WORLDS = {256: "single", 512: "multi"}


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def ref_flat(tree) -> dict:
    """{path names: leaf} of a reference tree, spec leaves as tuples, names
    by the reference's ``_path_names``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(rsh._path_names(p)): tuple(v) if isinstance(v, P) else v for p, v in flat}


def port_flat(tree, path=()) -> dict:
    """{path names: leaf} of a port tree (dict keys, list indices as str)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in port_flat(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in port_flat(sub, path + (str(i),)).items()}
    return {path: tree}


def shapes(flat: dict) -> dict:
    return {k: tuple(v.shape) for k, v in flat.items() if hasattr(v, "shape")}


def no_tp(arch: str) -> frozenset:
    return rsh.SSM_WEIGHT_NAMES if not rconfigs.get_config(arch).ssm_tp else frozenset()


def ref_opt_specs(arch: str, params, mesh) -> dict:
    """The reference's ``abstract_opt`` specs (``launch/specs.py:63-74``) on a
    shape-only mesh (its own needs a jax mesh of that many devices)."""
    state_dtype = jnp.bfloat16 if arch in rspecs.BF16_OPT else jnp.float32
    opt = jax.eval_shape(functools.partial(ref_adamw_init, state_dtype=state_dtype), params)
    dp = rmeshutil.dp_axes(mesh)
    return opt, {k: rsh.param_specs(opt[k], mesh, fsdp_axes=dp, no_tp_names=no_tp(arch))
                 for k in ("m", "v")} | {"step": P()}


def axis_size(mesh, entry) -> int:
    axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
    return int(np.prod([meshutil.axis_sizes(mesh)[a] for a in axes]))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's full-config parameter shapes, traced once per arch."""
    return {a: jax.eval_shape(functools.partial(ref_init_params, rconfigs.get_config(a)),
                              jax.random.key(0)) for a in ARCHS}


@pytest.fixture(scope="module")
def port_params():
    return {a: init_params(tconfigs.get_config(a), device="meta") for a in ARCHS}


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh_kind, fsdp, ref_params, port_params):
    mesh = MESHES[mesh_kind]
    dp = meshutil.dp_axes(mesh) if fsdp else ()
    assert meshutil.dp_axes(mesh) == rmeshutil.dp_axes(mesh)
    assert shapes(port_flat(port_params[arch])) == shapes(ref_flat(ref_params[arch]))
    want = ref_flat(rsh.param_specs(ref_params[arch], mesh, fsdp_axes=dp))
    got = port_flat(tsh.param_specs(port_params[arch], mesh, fsdp_axes=dp))
    assert got == want


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", SSM_NO_TP)
def test_param_specs_without_ssm_tp_match_reference(arch, mesh_kind, ref_params, port_params):
    mesh = MESHES[mesh_kind]
    dp = meshutil.dp_axes(mesh)
    assert tsh.SSM_WEIGHT_NAMES == rsh.SSM_WEIGHT_NAMES
    want = ref_flat(rsh.param_specs(ref_params[arch], mesh, fsdp_axes=dp,
                                    no_tp_names=rsh.SSM_WEIGHT_NAMES))
    got = port_flat(tsh.param_specs(port_params[arch], mesh, fsdp_axes=dp,
                                    no_tp_names=tsh.SSM_WEIGHT_NAMES))
    assert got == want
    # the SSM weights lose the model axis, and some leaf did have it
    full = port_flat(tsh.param_specs(port_params[arch], mesh, fsdp_axes=dp))
    assert any("model" in s and got[k] != s for k, s in full.items())
    assert not any("model" in s for k, s in got.items() if k[-1] in tsh.SSM_WEIGHT_NAMES)


# the reference's own checks (tests/test_sharding.py), run on the port


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divide(arch, mesh_kind, port_params):
    mesh = MESHES[mesh_kind]
    params = port_flat(port_params[arch])
    specs = port_flat(tsh.param_specs(port_params[arch], mesh,
                                      fsdp_axes=meshutil.dp_axes(mesh)))
    assert params.keys() == specs.keys()
    for k, leaf in params.items():
        for dim, entry in enumerate(specs[k]):
            assert leaf.shape[dim] % axis_size(mesh, entry) == 0, (arch, k, leaf.shape, specs[k])
        # the big leaves must actually be sharded on some axis
        if leaf.numel() >= 1 << 24:
            assert any(e is not None for e in specs[k]), (arch, k)


@pytest.mark.parametrize("arch", ["zamba2-7b", "llama4-maverick-400b-a17b",
                                  "falcon-mamba-7b", "seamless-m4t-medium"])
def test_cache_specs_divide_and_match_reference(arch):
    mesh = MESHES["single"]
    rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape in ("decode_32k", "long_500k"):
        cell = tconfigs.SHAPES[shape]
        if shape == "long_500k" and not tcfg.subquadratic:
            continue
        cache = init_cache(tcfg, cell.global_batch, cell.seq_len, device="meta")
        specs = port_flat(tsh.cache_specs(cache, mesh, dp_axes=("data",)))
        leaves = port_flat(cache)
        for k, leaf in leaves.items():
            if not isinstance(leaf, torch.Tensor):  # pos: a host int, no spec
                assert k[-1] == "pos" and specs[k] is None
                continue
            for dim, entry in enumerate(specs[k]):
                assert leaf.shape[dim] % axis_size(mesh, entry) == 0, (arch, shape, k)
        ref_cache = jax.eval_shape(
            functools.partial(ref_init_cache, rcfg, cell.global_batch, cell.seq_len))
        want = ref_flat(rsh.cache_specs(ref_cache, mesh, dp_axes=("data",)))
        assert {k: v for k, v in want.items() if k[-1] != "pos"} == \
            {k: v for k, v in specs.items() if k[-1] != "pos"}
        assert shapes(leaves) == {k: v for k, v in shapes(ref_flat(ref_cache)).items()
                                  if k[-1] != "pos"}


def test_batch_specs_divide_and_fallback():
    mesh = MESHES["multi"]
    batch = {"tokens": torch.empty((256, 4096), dtype=torch.int32, device="meta"),
             "odd": torch.empty((7, 3), device="meta")}
    specs = tsh.batch_specs(batch, mesh, dp_axes=("pod", "data"))
    assert specs["tokens"] == tuple(P(("pod", "data"), None))
    assert specs["odd"] == tuple(P(None, None))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_match_reference(arch):
    rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tspecs.active_param_count(tcfg) == rspecs.active_param_count(rcfg)
    for cell in tconfigs.SHAPES.values():
        args = (cell.seq_len, cell.global_batch, cell.step)
        assert tspecs.model_flops(tcfg, *args) == rspecs.model_flops(rcfg, *args)


def test_train_microbatches_match_reference(monkeypatch):
    assert tspecs.TRAIN_MICROBATCHES == rspecs.TRAIN_MICROBATCHES
    assert tspecs.BF16_OPT == rspecs.BF16_OPT
    monkeypatch.delenv("REPRO_MICROBATCHES", raising=False)
    monkeypatch.delenv(tspecs.ENV_MICROBATCHES, raising=False)
    assert [tspecs.train_microbatches(a) for a in ARCHS] == \
        [rspecs.train_microbatches(a) for a in ARCHS]
    monkeypatch.setenv("REPRO_MICROBATCHES", "3")
    monkeypatch.setenv(tspecs.ENV_MICROBATCHES, "3")
    assert [tspecs.train_microbatches(a) for a in ARCHS] == [3] * len(ARCHS) == \
        [rspecs.train_microbatches(a) for a in ARCHS]
    monkeypatch.delenv("REPRO_MICROBATCHES")
    assert tspecs.train_microbatches("arctic-480b") == 3  # the port reads its own name only
    assert rspecs.train_microbatches("arctic-480b") == 8


def test_placements_one_per_mesh_dim():
    mesh = MESHES["multi"]
    assert tsh.placements((("pod", "data"), None, "model"), mesh) == [Shard(0), Shard(0),
                                                                       Shard(2)]
    assert tsh.placements((None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    assert tsh.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        tsh.placements(("model", "model"), mesh)


def test_init_cache_meta_allocates_nothing():
    for arch in ARCHS:
        cfg = tconfigs.get_reduced(arch)
        meta, cpu = (port_flat(init_cache(cfg, 2, 16, device=d)) for d in ("meta", "cpu"))
        assert meta.keys() == cpu.keys()
        for k, leaf in meta.items():
            if isinstance(leaf, torch.Tensor):
                assert leaf.is_meta and (leaf.shape, leaf.dtype) == (cpu[k].shape, cpu[k].dtype)
            else:
                assert leaf == cpu[k] == 0  # pos
    with pytest.raises(ValueError):  # the entry points' rule stands for other devices
        init_cache(tconfigs.get_reduced("llama3.2-1b"), 1, 4, device="xla")


def test_meshes_start_no_process_group_and_check_the_world():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh(device_type="cpu")
    assert not dist.is_initialized()
    with fake_world(8, rank=5):
        with pytest.raises(ValueError, match="needs 256 ranks; the world has 8"):
            make_production_mesh(device_type="cpu")
        mesh = make_host_mesh(device_type="cpu")
        assert (mesh.shape, mesh.mesh_dim_names) == ((8, 1), ("data", "model"))
        assert meshutil.dp_axes(mesh) == ("data",)
        mesh = make_host_mesh(axes=("data",), device_type="cpu")
        assert (mesh.shape, meshutil.axis_sizes(mesh)) == ((8,), {"data": 8})
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert meshutil.axis_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_input_specs_meta_dtensors_match_reference(world, arch, ref_params):
    """Every applicable cell on the production mesh: meta DTensors placed by
    specs equal to the reference's, each rank's shape the spec's share."""
    shape_mesh = MESHES[WORLDS[world]]
    dp = rmeshutil.dp_axes(shape_mesh)
    rcfg = rconfigs.get_config(arch)
    want_params = ref_flat(rsh.param_specs(ref_params[arch], shape_mesh, fsdp_axes=dp,
                                           no_tp_names=no_tp(arch)))
    ref_opt, want_opt = ref_opt_specs(arch, ref_params[arch], shape_mesh)
    with fake_world(world, rank=world - 1):
        mesh = make_production_mesh(multi_pod=world == 512, device_type="cpu")
        for shape in tconfigs.SHAPES:
            if not tconfigs.cell_applicable(arch, shape)[0]:
                continue
            cell = tconfigs.SHAPES[shape]
            out = tspecs.input_specs(arch, shape, mesh)
            assert port_flat(out["param_specs"]) == want_params
            ref_batch = rspecs.batch_shapes(rcfg, cell.seq_len, cell.global_batch, cell.step)
            assert port_flat(out["batch_specs"]) == ref_flat(
                rsh.batch_specs(ref_batch, shape_mesh, dp_axes=dp))
            groups = [("params", "param_specs"), ("batch", "batch_specs")]
            want_batch = ref_flat(ref_batch)
            if cell.step == "train":
                assert port_flat(out["opt_specs"]) == ref_flat(want_opt)
                groups.append(("opt", "opt_specs"))
                want_dtypes = {k: v.dtype for k, v in ref_flat(ref_opt).items()}
                assert {k: str(v.dtype).removeprefix("torch.") for k, v in
                        port_flat(out["opt"]).items()} == {k: str(v) for k, v in
                                                          want_dtypes.items()}
            else:
                ref_cache = jax.eval_shape(functools.partial(
                    ref_init_cache, rcfg, cell.global_batch, cell.seq_len))
                want = ref_flat(rsh.cache_specs(ref_cache, shape_mesh, dp_axes=dp))
                got = port_flat(out["cache_specs"])
                assert {k: v for k, v in got.items() if v is not None} == \
                    {k: v for k, v in want.items() if k[-1] != "pos"}
                groups.append(("cache", "cache_specs"))
            assert shapes(port_flat(out["batch"])) == shapes(want_batch)
            for tree, spec_tree in groups:
                specs = port_flat(out[spec_tree])
                for k, leaf in port_flat(out[tree]).items():
                    if not isinstance(leaf, torch.Tensor):
                        assert k[-1] == "pos" and specs[k] is None
                        continue
                    assert isinstance(leaf, DTensor) and leaf.to_local().is_meta, (tree, k)
                    assert list(leaf.placements) == tsh.placements(specs[k], mesh)
                    share = tuple(s // axis_size(shape_mesh, e)
                                  for s, e in zip(leaf.shape, specs[k]))
                    assert tuple(leaf.to_local().shape) == share == \
                        tsh.local_shape(leaf.shape, specs[k], mesh), (tree, k)


JAX_INDICES = """
import json, jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 16, 16), ("pod", "data", "model"))
out = {}
for name, spec in (("rows", P(("pod", "data"), "model")), ("cols", P("model", ("pod", "data")))):
    m = NamedSharding(mesh, spec).devices_indices_map((64, 32))
    out[name] = {d.id: [[s.start, s.stop] for s in sl] for d, sl in m.items()}
print(json.dumps(out))
"""
POD_MAJOR_SPECS = {"rows": (("pod", "data"), "model"), "cols": ("model", ("pod", "data"))}


@pytest.fixture(scope="module")
def jax_indices():
    """Each device's slice of a (64, 32) array under JAX's multi-axis specs
    on a 2 x 16 x 16 mesh of 512 host devices (device i at mesh position i)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    run = subprocess.run([sys.executable, "-c", JAX_INDICES], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    return json.loads(run.stdout)


@pytest.mark.parametrize("rank", [0, 17, 255, 256, 300, 511])
def test_multi_axis_dims_split_pod_major_as_jax(rank, jax_indices):
    x = torch.arange(64 * 32).reshape(64, 32)
    with fake_world(512, rank=rank):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        placed = tsh.shard_tree(dict.fromkeys(POD_MAJOR_SPECS, x), POD_MAJOR_SPECS, mesh)
        for name, dt in placed.items():
            (r0, r1), (c0, c1) = jax_indices[name][str(rank)]
            assert torch.equal(dt.to_local(), x[r0:r1, c0:c1]), (name, rank)
