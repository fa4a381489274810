"""Activation recomputation: the reference's ``jax.checkpoint``.

``checkpointed(fn, *args)`` runs ``fn(*args)`` under
``torch.utils.checkpoint`` (non-reentrant): the forward keeps ``fn``'s inputs
only, and the backward runs ``fn`` again to rebuild what its gradient needs.
Tensors ``fn`` closes over (parameters, the encoder's output) get their
gradients as usual. A run of ``fn`` inside the backward is a recomputation,
not a forward call: ``recomputing()`` is true there, so counters of forward
calls skip it. The recomputation runs under the ambient mesh of the
forward (``meshutil.set_mesh``), so its ``constrain`` calls place the
activations as the forward did, whichever thread runs the backward.
"""
from __future__ import annotations

import threading

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.meshutil import get_mesh, set_mesh

_local = threading.local()  # a CUDA backward recomputes on autograd's device thread


def recomputing() -> bool:
    """True while a checkpointed function is being recomputed."""
    return getattr(_local, "depth", 0) > 0


def checkpointed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward. Without
    grad mode it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    runs = [0]
    mesh = get_mesh()

    def run(*a):
        runs[0] += 1
        if runs[0] == 1:
            return fn(*a)
        _local.depth = getattr(_local, "depth", 0) + 1
        try:
            with set_mesh(mesh):
                return fn(*a)
        finally:
            _local.depth -= 1

    # the models draw no random numbers, so no generator state is kept
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
