"""Helpers for the LM parity tests (``tests/test_torch_models.py``,
``tests/test_torch_lm_serve.py``): the reference's reduced configs in
float32, its parameters in the port's layout, inputs from a numpy seed, and
the reference's ``forward`` jitted once per config and shape.

Both packages see the same numpy arrays; results are compared as numpy.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as rconfigs
from repro.models import model as rmodel
from repro_torch import configs as tconfigs
from repro_torch.models.convert import params_from_reference

KEY = jax.random.PRNGKey(0)
F32 = dict(dtype="float32", param_dtype="float32")


def configs(arch: str):
    """(reference, port) reduced configs of ``arch``, switched to float32."""
    return (dataclasses.replace(rconfigs.get_reduced(arch), **F32),
            dataclasses.replace(tconfigs.get_reduced(arch), **F32))


@functools.lru_cache(maxsize=None)
def _ref_params_np(arch: str):
    """The reference's ``init_params``, compiled once without XLA's backend
    optimizations: on the CPU a third less time than running it eagerly."""
    rcfg, _ = configs(arch)
    init = jax.jit(rmodel.init_params, static_argnums=0).lower(rcfg, KEY).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jax.tree.map(np.asarray, init(KEY))


def params(arch: str):
    """(reference params as jnp, the same values as the port's CPU tensors)."""
    tree = _ref_params_np(arch)
    _, tcfg = configs(arch)
    return jax.tree.map(jnp.asarray, tree), params_from_reference(tcfg, tree)


def inputs(cfg, B: int, S: int, seed: int = 0) -> dict:
    """numpy inputs for a forward: tokens (or embeds) and, for an
    encoder-decoder, encoder embeddings."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_kind == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    else:
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    if cfg.enc_layers:
        out["enc_embeds"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                                dtype=np.float32)
    return out


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


ref_forward = jax.jit(rmodel.forward, static_argnames=("cfg", "last_only", "remat"))
ref_encode = jax.jit(rmodel.encode, static_argnames=("cfg",))
ref_loss = jax.jit(rmodel.loss_fn, static_argnames=("cfg", "remat"))
