"""A ``torch.distributed`` backend for ranks that share one card: each
collective on CUDA tensors is staged through host memory and run by gloo on
CPU tensors.

Gloo's own CUDA paths crash under DTensor's functional collectives in the
card machine's torch (PERF.md §7), and NCCL refuses two ranks on one card.
This backend is registered under the name ``"staged"`` (:data:`BACKEND`)
for CPU and CUDA tensors: ``init_process_group("staged", ...)``. Every
collective copies its inputs to the host (a no-op for CPU tensors), runs
the gloo collective of an inner gloo group of the same ranks there, copies
the results back and returns a finished ``Work``: synchronous, exact (the
same reduction gloo does), and slow (two host copies a call).

Call :func:`register` before ``init_process_group``; it is idempotent.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.futures import Future

BACKEND = "staged"
_REGISTERED = False


def _done(result) -> dist.Work:
    fut = Future()
    fut.set_result(result)
    return torch._C._distributed_c10d._create_work_from_future(fut)


def _host(ts):
    return [t.detach().to("cpu") for t in ts]


def _empty(t):
    return torch.empty_like(t, device="cpu")


def _back(dst, src) -> None:
    for d, s in zip(dst, src, strict=True):
        d.copy_(s)


class StagedGroup(dist.ProcessGroup):
    """The collectives DTensor and the port issue, each through a gloo
    group of the same ranks on host copies."""

    def __init__(self, store, rank: int, size: int, timeout: datetime.timedelta):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(dist.PrefixStore("staged", store), rank, size,
                                           timeout)

    def getBackendName(self) -> str:  # noqa: N802 (torch's name)
        return "staged"

    @property
    def group_name(self) -> str:
        """The name the group was registered under (a Python group keeps no
        name of its own: torch's threaded test group reads it the same way)."""
        return dist.distributed_c10d._world.pg_names[self]

    def allreduce(self, tensors, opts=None):
        opts = opts or dist.AllreduceOptions()
        host = _host(tensors)
        self._gloo.allreduce(host, opts).wait()
        _back(tensors, host)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        opts_ = dist.AllreduceOptions()
        if opts is not None:
            opts_.reduceOp = opts.reduceOp
        for t in tensors:
            self.allreduce([t], opts_)
        return _done(tensors)

    def allgather(self, outputs, inputs, opts=None):
        host_out = [[_empty(t) for t in o] for o in outputs]
        self._gloo.allgather(host_out, _host(inputs)).wait()
        for o, h in zip(outputs, host_out, strict=True):
            _back(o, h)
        return _done(outputs)

    def _allgather_base(self, output, input, opts=None):
        host = _empty(output)
        self._gloo._allgather_base(host, input.detach().to("cpu")).wait()
        output.copy_(host)
        return _done([output])

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs, strict=True):
            self._allgather_base(o, i)
        return _done(outputs)

    def reduce_scatter(self, outputs, inputs, opts=None):
        opts = opts or dist.ReduceScatterOptions()
        host_out = [_empty(t) for t in outputs]
        self._gloo.reduce_scatter(host_out, [_host(i) for i in inputs], opts).wait()
        _back(outputs, host_out)
        return _done(outputs)

    def _reduce_scatter_base(self, output, input, opts=None):
        opts = opts or dist.ReduceScatterOptions()
        host = _empty(output)
        self._gloo._reduce_scatter_base(host, input.detach().to("cpu"), opts).wait()
        output.copy_(host)
        return _done([output])

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs, strict=True):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    def broadcast(self, tensors, opts=None):
        opts = opts or dist.BroadcastOptions()
        host = _host(tensors)
        self._gloo.broadcast(host, opts).wait()
        _back(tensors, host)
        return _done(tensors)

    def alltoall_base(self, output, input, output_split_sizes, input_split_sizes, opts=None):
        host = _empty(output)
        self._gloo.alltoall_base(host, input.detach().to("cpu"), output_split_sizes,
                                 input_split_sizes).wait()
        output.copy_(host)
        return _done([output])

    def barrier(self, opts=None):
        self._gloo.barrier().wait()
        return _done([])


def _create(store, rank, size, timeout):
    return StagedGroup(store, rank, size, timeout)


def register() -> None:
    """Register the ``"staged"`` backend for CUDA (and CPU) tensors."""
    global _REGISTERED
    if not _REGISTERED:
        dist.Backend.register_backend("staged", _create, devices=["cpu", "cuda"])
        _REGISTERED = True
