"""The train step: loss -> grad -> AdamW, with remat and microbatches.

``make_train_step(cfg, device)`` returns ``step(params, opt_state, batch,
step) -> (params, opt_state, metrics)``. The batch (``SyntheticLM.batch``'s
numpy arrays or tensors) moves to the device; the parameters and the
optimizer state are moved too if they are not there yet (a no-op once they
are) and then updated in place (``optim.adamw_update``). ``metrics`` holds
0-d tensors ``loss``, ``gnorm`` and ``lr``, left on the device.
``donate=False`` updates copies and leaves the caller's trees as they were.

With ``microbatches > 1`` the batch splits on its leading axis (microbatch
``i`` takes rows ``[i B/mb, (i+1) B/mb)``) and the gradients accumulate in
the **gradient's own dtype** (bfloat16 for bfloat16 parameters: ``acc +
(g / microbatches).to(acc.dtype)``), the loss in float32, as the reference
accumulates them. ``grad_allreduce_dtype`` casts the gradients before
AdamW (the reference's gradient compression; it changes values).

On a mesh (``mesh=``, a ``DeviceMesh`` with a ``"model"`` axis), with
``example_params``/``example_opt``/``example_batch`` the step places its
inputs on entry by the sharding rules (parameters by ``param_specs``, FSDP
over the data axes if ``fsdp``, SSM weights without TP unless
``cfg.ssm_tp``; the moments by the same specs, ``step`` replicated, the
batch by ``batch_specs``): a no-op for inputs already placed so, a
redistribution for DTensors placed otherwise, a slice of every rank's
copy for plain tensors. The body runs under ``set_mesh(mesh)``, so the
model's ``constrain`` calls apply. The gradients take their parameters'
placements, the outputs keep theirs, and the metrics come back as
replicated DTensors. With a mesh and no ``example_*`` it returns the bare
step: no placement, and ``constrain`` reads the caller's ambient mesh.
Microbatches on a mesh are cut from the whole batch and each is placed by
the batch rule.

Each step is recorded as the span ``train.step`` and the counter
``train.steps`` in the port's telemetry.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.device import resolve_device
from repro_torch.distributed.constraints import replicated, whole
from repro_torch.distributed.meshutil import dp_axes, mesh_device, set_mesh
from repro_torch.distributed.sharding import (
    SSM_WEIGHT_NAMES, batch_specs, param_specs, shard_tree,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import loss_fn, tree_leaves, tree_map
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.train.optim import adamw_update, cosine_schedule


def value_and_grad(cfg: ModelConfig, params: dict, batch: dict, *, remat: bool = True):
    """``(loss, grads)`` of ``loss_fn`` on one batch of tensors: ``grads``
    has the tree of ``params`` and each leaf's dtype (and a DTensor leaf's
    placements); a leaf the loss does not reach gets zeros (as ``jax.grad``
    gives)."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = loss_fn(tree, cfg, batch.get("tokens"), batch["labels"],
                       embeds=batch.get("embeds"), enc_embeds=batch.get("enc_embeds"),
                       remat=remat)
        gs = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else _like(g, p) for p, g in zip(leaves, gs)])
    return loss.detach(), tree_map(lambda _: next(it), params)


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient placed as its parameter."""
    if isinstance(p, DTensor) and list(g.placements) != list(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _whole(v, dev: torch.device) -> torch.Tensor:
    return whole(v) if isinstance(v, DTensor) else torch.as_tensor(v).to(dev)


def _copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def make_train_step(cfg: ModelConfig, device=None, *, mesh=None, microbatches: int = 1,
                    peak_lr: float = 3e-4, warmup: int = 100, total_steps: int = 10000,
                    remat: bool = True, fsdp: bool = False,
                    grad_allreduce_dtype: str | None = None, example_params=None,
                    example_opt=None, example_batch=None, donate: bool = True):
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    cast = torch_dtype(grad_allreduce_dtype) if grad_allreduce_dtype else None
    placed = mesh is not None and example_params is not None

    def on(tree):
        return tree_map(lambda t: t if isinstance(t, DTensor) else t.to(dev), tree)

    if placed:
        dp = dp_axes(mesh)
        no_tp = SSM_WEIGHT_NAMES if not cfg.ssm_tp else frozenset()

        def pspecs(tree):
            return param_specs(tree, mesh, fsdp_axes=dp if fsdp else (), no_tp_names=no_tp)

        specs = (pspecs(example_params),
                 {"m": pspecs(example_opt["m"]), "v": pspecs(example_opt["v"]), "step": ()})

        def place_batch(b):
            return shard_tree(b, batch_specs(b, mesh, dp_axes=dp), mesh, dev)
    else:
        def place_batch(b):
            return {k: v if isinstance(v, DTensor) else torch.as_tensor(v).to(dev)
                    for k, v in b.items()}

    def body(params, opt_state, batch, step):
        if microbatches > 1:
            if placed:
                batch = {k: _whole(v, dev) for k, v in batch.items()}
            loss, grads = None, None
            for mb in range(microbatches):
                part = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                     + v.shape[1:])[mb] for k, v in batch.items()}
                l_mb, g_mb = value_and_grad(cfg, params, place_batch(part), remat=remat)
                if grads is None:
                    grads = tree_map(torch.zeros_like, params)
                    loss = replicated(torch.zeros((), dtype=torch.float32, device=dev), l_mb)
                for a, g in zip(tree_leaves(grads), tree_leaves(g_mb)):
                    a.copy_(a + (g / microbatches).to(a.dtype))
                loss = loss + l_mb / microbatches
                del g_mb
        else:
            loss, grads = value_and_grad(cfg, params, place_batch(batch), remat=remat)
        if cast is not None:
            grads = tree_map(lambda g: g.to(cast), grads)
        like = tree_leaves(params)[0]
        lr = replicated(cosine_schedule(step, peak_lr=peak_lr, warmup=warmup,
                                        total=total_steps).to(dev), like)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state, lr=lr)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    def step_fn(params, opt_state, batch, step):
        with get_tracer().span("train.step", step=int(step)):
            get_registry().counter("train.steps").inc()
            params, opt_state = on(params), on(opt_state)
            if not donate:
                params, opt_state = _copy(params), _copy(opt_state)
            if not placed:
                return body(params, opt_state, batch, step)
            params = shard_tree(params, specs[0], mesh, dev)
            opt_state = shard_tree(opt_state, specs[1], mesh, dev)
            if microbatches == 1:
                batch = place_batch(batch)
            with set_mesh(mesh):
                params, opt_state, metrics = body(params, opt_state, batch, step)
                metrics = {k: v.redistribute(mesh, [Replicate()] * mesh.ndim)
                           for k, v in metrics.items()}
            return params, opt_state, metrics

    return step_fn

