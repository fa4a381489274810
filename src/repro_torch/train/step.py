"""The train step: loss -> grad -> AdamW, with remat and microbatches.

``make_train_step(cfg, device)`` returns ``step(params, opt_state, batch,
step) -> (params, opt_state, metrics)``. The batch (``SyntheticLM.batch``'s
numpy arrays or tensors) moves to the device; the parameters and the
optimizer state are moved too if they are not there yet (a no-op once they
are) and then updated in place (``optim.adamw_update``). ``metrics`` holds
0-d tensors ``loss``, ``gnorm`` and ``lr``, left on the device.

With ``microbatches > 1`` the batch splits on its leading axis and the
gradients accumulate in the **gradient's own dtype** (bfloat16 for
bfloat16 parameters: ``acc + (g / microbatches).to(acc.dtype)``), the loss
in float32, as the reference accumulates them. ``grad_allreduce_dtype``
casts the gradients before AdamW: on one device that cast is all the
reference's gradient compression does, and it changes values. The
reference's mesh, ``fsdp``, ``example_*`` and ``donate`` arguments belong to
sharding and are not taken here.

Each step is recorded as the span ``train.step`` and the counter
``train.steps`` in the port's telemetry.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import loss_fn, tree_leaves, tree_map
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.train.optim import adamw_update, cosine_schedule


def value_and_grad(cfg: ModelConfig, params: dict, batch: dict, *, remat: bool = True):
    """``(loss, grads)`` of ``loss_fn`` on one batch of tensors: ``grads``
    has the tree of ``params`` and each leaf's dtype; a leaf the loss does
    not reach gets zeros (as ``jax.grad`` gives)."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = loss_fn(tree, cfg, batch.get("tokens"), batch["labels"],
                       embeds=batch.get("embeds"), enc_embeds=batch.get("enc_embeds"),
                       remat=remat)
        gs = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)])
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, device=None, *, microbatches: int = 1,
                    peak_lr: float = 3e-4, warmup: int = 100, total_steps: int = 10000,
                    remat: bool = True, grad_allreduce_dtype: str | None = None):
    dev = resolve_device(device)
    cast = torch_dtype(grad_allreduce_dtype) if grad_allreduce_dtype else None

    def on(tree):
        return tree_map(lambda t: t.to(dev), tree)

    def step_fn(params, opt_state, batch, step):
        with get_tracer().span("train.step", step=int(step)):
            get_registry().counter("train.steps").inc()
            params, opt_state = on(params), on(opt_state)
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            if microbatches > 1:
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                grads = tree_map(torch.zeros_like, params)
                for mb in range(microbatches):
                    part = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                         + v.shape[1:])[mb] for k, v in batch.items()}
                    l_mb, g_mb = value_and_grad(cfg, params, part, remat=remat)
                    for a, g in zip(tree_leaves(grads), tree_leaves(g_mb)):
                        a.copy_(a + (g / microbatches).to(a.dtype))
                    loss = loss + l_mb / microbatches
                    del g_mb
            else:
                loss, grads = value_and_grad(cfg, params, batch, remat=remat)
            if cast is not None:
                grads = tree_map(lambda g: g.to(cast), grads)
            lr = cosine_schedule(step, peak_lr=peak_lr, warmup=warmup,
                                 total=total_steps).to(dev)
            params, opt_state, gnorm = adamw_update(params, grads, opt_state, lr=lr)
            return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return step_fn
