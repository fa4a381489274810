"""The multi-device executors' exchange over a ``torch.distributed`` group.

The reference runs one program over a device mesh (``shard_map``) and
combines per-device partial sums with ``jax.lax.psum`` over its axis. The
port runs one process per device, each a rank of a process group, and
combines them with ``all_reduce(SUM)``: the unified executors' dense
``delta`` sum, the zerocopy executors' packed boundary rows, the syncfree
sweep's values and counts (the rows left over the group ride with the
counts), every solve's gather and the SpMV's partial products. The
sessions above the executors agree through the others: the largest (plan
digests, a Krylov loop's residuals, probe times), the smallest (plan-store
hits), rank 0's object (the tuner's scores, the engine's batches) and a
barrier (after rank 0 writes a stored plan). This module names no backend
and never picks a device: the caller creates the group, ``nccl`` where
each rank has a card of its own, ``gloo`` for CPU tensors or several ranks
sharing one card (gloo stages CUDA tensors through host memory), and hands
it to the executor (``core.solver.Solver(group=...)``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def rank(group) -> int:
    """This process's rank in ``group``: the device index of the plan's
    tables it runs."""
    return dist.get_rank(group)


def size(group) -> int:
    """The number of ranks in ``group``: the plan's device count."""
    return dist.get_world_size(group)


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` in place (the reference's
    ``psum`` over its device axis) and return it. Blocks until every rank
    has called it; counted in ``all_reduce_sum_.calls``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum_.calls += 1
    return t


all_reduce_sum_.calls = 0


def all_reduce_max_(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise largest ``t`` over the ranks of ``group``, in place
    (the session's agreements: the plan digests, the stop test of a Krylov
    loop, the auto-tuner's probe times; not counted with the exchanges).
    A no-op for ``group=None``."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_reduce_min_(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise smallest ``t`` over the ranks of ``group``, in place
    (whether every rank found a stored plan). A no-op for ``group=None``."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t


def group_max(values, group, device) -> np.ndarray:
    """The elementwise largest of ``values`` (array-like of floats) over
    the ranks of ``group``, as float64 numpy: one ``all_reduce`` of a
    tensor on ``device`` (the session's, so ``nccl`` gets a card tensor).
    Returns ``values`` as an array for ``group=None``."""
    a = np.array(values, np.float64)  # a copy: the reduction writes in place
    if group is None:
        return a
    t = torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(device)
    return all_reduce_max_(t, group).cpu().numpy().reshape(a.shape)


def broadcast_object(obj, group):
    """Rank 0's ``obj`` (any picklable object) on every rank of ``group``;
    the other ranks' ``obj`` is ignored. Returns ``obj`` for
    ``group=None``."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def barrier(group) -> None:
    """Wait until every rank of ``group`` has called it. A no-op for
    ``group=None``."""
    if group is not None:
        dist.barrier(group=group)
