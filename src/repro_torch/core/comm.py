"""The multi-device executors' exchange over a ``torch.distributed`` group.

The reference runs one program over a device mesh (``shard_map``) and
combines per-device partial sums with ``jax.lax.psum`` over its axis. The
port runs one process per device, each a rank of a process group, and
combines them with ``all_reduce(SUM)``: the unified executors' dense
``delta`` sum, the zerocopy executors' packed boundary rows, the syncfree
sweep's values and counts (the rows left over the group ride with the
counts), and every solve's gather. This module names no backend and never
picks a device: the caller creates the group, ``nccl`` where each rank has
a card of its own, ``gloo`` for CPU tensors or several ranks sharing one
card (gloo stages CUDA tensors through host memory), and hands it to the
executor (``core.solver.Solver(group=...)``).
"""
from __future__ import annotations

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
    (the session's check that every rank built the same plan; not counted
    with the exchanges)."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t
