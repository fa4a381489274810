"""The solve-serving engine loop.

One :class:`SolveEngine` drives one :class:`repro_torch.api.SpTRSVContext`
on one device: batches admitted by the :class:`repro_torch.service.queue.SolveQueue`
are analysed through the plan store (a cold pattern pays the symbolic
analysis once per *store*, not once per process), numeric value changes on
a hot pattern refresh in place through the factorize path (no
re-partition), and the coalesced ``(n, R)`` panel runs as one multi-RHS
solve: the TRSM/GEMM kernels once per level with work under ``cuda``, one
megakernel launch under the fused backends.

Every launch the engine makes goes to one CUDA stream, :attr:`SolveEngine.stream`
(the caller's current stream when the engine is built, unless one is passed
in), whichever thread serves the batch: a megakernel executor keeps one
:class:`repro_torch.kernels.superstep.ReadyFlags`, which serves launches on
one stream, one after another.

Telemetry rides through :mod:`repro_torch.obs`: ``service.*`` metrics
(queue depth, coalesce width, plan-store hit rate, per-request/batch
latency histograms) mirror the engine's own counters field for field, and
every batch/request emits a ``service.batch`` / ``service.request`` span.
The tracer never touches a tensor, so served results are bit-identical with
tracing on or off.

Drive it synchronously (``step`` / ``drain`` — deterministic, what the tests
use) or as a background thread (``start`` / ``stop`` or the context
manager), which serves tickets while tenants block on
:meth:`repro_torch.service.queue.Ticket.result`.

On a ``torch.distributed`` group (``group=``, one rank per device) the
engine serves on every device of the group. Rank 0 is the front end:
tenants submit to it and its queue forms the batches. For each batch it
broadcasts what the other ranks need to run the same solve (the batch's
value key, its matrix the first time a rank meets that key, the coalesced
panel); they serve in :meth:`SolveEngine.follow` until rank 0 closes the
engine (:meth:`SolveEngine.close`, or ``stop`` at the end of background
serving). Every rank runs the same session calls in the same order, so
their collectives meet.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.service.planstore import PlanStore
from repro_torch.service.queue import SolveQueue, Ticket
from repro_torch.sparse.matrix import CSR


class SolveEngine:
    """Multi-tenant batched SpTRSV server over one session context.

    ``device`` is the session's (``None``: the card; raises without one
    unless ``"cpu"`` is asked for). ``plan_store`` takes a
    :class:`repro_torch.service.planstore.PlanStore` or a directory path
    (coerced); ``cache_capacity`` bounds the context's executor cache (LRU,
    ``session.evictions``). ``stream`` is the CUDA stream every launch goes
    to (default: the current stream of ``device`` at construction; ignored
    on the CPU). ``group``: serve on every rank of a ``torch.distributed``
    group (rank 0 takes the requests, the others :meth:`follow`).
    """

    KNOWN_MATRICES = 64  # value keys whose matrix every rank holds (LRU)

    def __init__(self, device: str | torch.device | None = None, options=None, *,
                 plan_store: PlanStore | str | None = None,
                 queue: SolveQueue | None = None, registry=None,
                 cache_capacity: int | None = None, max_batch: int = 8,
                 max_wait_s: float = 0.0, max_pending: int = 1024,
                 stream: torch.cuda.Stream | None = None, group=None):
        from repro_torch.api import SpTRSVContext

        self.registry = registry if registry is not None else get_registry()
        if isinstance(plan_store, str):
            plan_store = PlanStore(plan_store, registry=self.registry)
        self.plan_store = plan_store
        self.queue = queue if queue is not None else SolveQueue(
            max_batch=max_batch, max_wait_s=max_wait_s,
            max_pending=max_pending)
        self.ctx = SpTRSVContext(device=device, options=options,
                                 registry=self.registry,
                                 plan_store=plan_store,
                                 cache_capacity=cache_capacity, group=group)
        self.device = self.ctx.device
        self.group = group
        self.rank = 0 if group is None else comm.rank(group)
        self._known: collections.OrderedDict[str, CSR] = collections.OrderedDict()
        self._closed = False
        self.stream = None
        if self.device.type == "cuda":
            self.stream = stream if stream is not None else torch.cuda.current_stream(self.device)
        self._counters: collections.Counter = collections.Counter()
        self._stop_flag = threading.Event()
        self._thread: threading.Thread | None = None

    # -- bookkeeping -------------------------------------------------------

    def _count(self, name: str, v: int = 1) -> None:
        self._counters[name] += v
        self.registry.counter(f"service.{name}").inc(v)

    def _observe_depth(self) -> None:
        self.registry.gauge("service.queue_depth").set(self.queue.depth)
        if self.plan_store is not None:
            self.registry.gauge("service.plan_store_hit_rate").set(
                self.plan_store.stats["hit_rate"])

    def stats(self) -> dict:
        """Engine counters (the ground truth the ``service.*`` registry
        counters are reconciled against) plus live queue depth, the plan
        store's counters, and the underlying session's counters."""
        c = dict(self._counters)
        c["queue_depth"] = self.queue.depth
        if self.plan_store is not None:
            c["plan_store"] = self.plan_store.stats
        c["session"] = self.ctx.stats()
        return c

    def _on_stream(self):
        """The engine's stream as the current one, for one batch."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # -- request intake ----------------------------------------------------

    def submit(self, tenant: str, matrix: CSR, rhs: np.ndarray, *,
               transpose: bool = False) -> Ticket:
        """Enqueue one tenant solve; returns the ticket whose ``result()``
        blocks until a batch containing it is served. Raises
        :class:`repro_torch.service.queue.QueueFull` under backpressure."""
        self._check_front("submit")
        ticket = self.queue.submit(tenant, matrix, rhs, transpose=transpose)
        self._count("requests")
        self._observe_depth()
        return ticket

    # -- serve loop --------------------------------------------------------

    def step(self, *, force: bool = True) -> int:
        """Serve one admitted batch; returns the number of requests resolved
        (0 when nothing is ready). ``force=False`` honours the admission
        window (the background loop); the default drains unconditionally."""
        self._check_front("step")
        batch = self.queue.next_batch(force=force)
        if not batch:
            self._observe_depth()
            return 0
        reqs = [t.request for t in batch]
        t0 = time.perf_counter()
        with get_tracer().span("service.batch", pattern=reqs[0].pattern,
                               n_requests=len(batch),
                               tenants=len({r.tenant for r in reqs})) as span:
            try:
                panel, r = self.queue.coalesce(batch)
                req = reqs[0]
                if self.group is not None:  # the other ranks run the same solve
                    sent = None if req.vkey in self._known else req.matrix
                    self._remember(req.vkey, req.matrix)
                    comm.broadcast_object(("solve", req.vkey, sent, panel, req.transpose),
                                          self.group)
                x = self._serve(req.matrix, panel, req.transpose)
                self.queue.scatter(batch, x)
            except Exception as e:
                for t in batch:
                    t._resolve(error=e)
                self._count("errors", len(batch))
                span.set(error=type(e).__name__)
                self._observe_depth()
                return len(batch)
            rp = panel.shape[1]
            span.set(width=r, padded_width=rp)
        batch_us = (time.perf_counter() - t0) * 1e6
        self._count("batches")
        self._count("solves")
        self._count("results", len(batch))
        self._count("coalesced_columns", r)
        self._count("pad_columns", rp - r)
        self.registry.histogram("service.batch_us").observe(batch_us)
        self.registry.histogram("service.coalesce_width").observe(r)
        tracer = get_tracer()
        for t in batch:
            with tracer.span("service.request", tenant=t.request.tenant,
                             id=t.request.id,
                             latency_us=t.latency_s * 1e6):
                self.registry.histogram("service.request_us").observe(
                    t.latency_s * 1e6)
        self._observe_depth()
        return len(batch)

    def _serve(self, matrix: CSR, panel: np.ndarray, transpose: bool) -> np.ndarray:
        """One batch's session calls: analyse (a pattern-cache or plan-store
        hit when warm; changed values on a hot pattern factorize in place)
        and one multi-RHS solve, on the engine's stream."""
        with self._on_stream():
            handle = self.ctx.analyse(matrix)
            return np.asarray(self.ctx.solve(handle, panel, transpose=transpose))

    def _remember(self, vkey: str, matrix: CSR | None) -> CSR:
        """The matrix of value key ``vkey``, kept in an LRU of
        :attr:`KNOWN_MATRICES` keys that every rank updates in the same
        order (rank 0 sends a matrix only when its key is not in it)."""
        if vkey in self._known:
            self._known.move_to_end(vkey)
            return self._known[vkey]
        if matrix is None:
            raise RuntimeError(f"rank {self.rank} was sent no matrix for value key {vkey}")
        self._known[vkey] = matrix
        while len(self._known) > self.KNOWN_MATRICES:
            self._known.popitem(last=False)
        return matrix

    def _check_front(self, what: str) -> None:
        if self.rank != 0:
            raise RuntimeError(f"{what}: rank {self.rank} follows rank 0, which takes the "
                               f"requests; call follow() (or start()) here")
        if self._closed:
            raise RuntimeError(f"{what}: the engine is closed")

    def follow(self) -> int:
        """A rank other than 0: run each batch rank 0 broadcasts, until rank 0
        closes the engine; returns the batches served."""
        if self.group is None or self.rank == 0:
            raise RuntimeError("follow() runs on the ranks of a group other than 0")
        served = 0
        while True:
            msg = comm.broadcast_object(None, self.group)
            if msg[0] == "close":
                self._closed = True
                return served
            _, vkey, matrix, panel, transpose = msg
            matrix = self._remember(vkey, matrix)
            try:
                self._serve(matrix, panel, transpose)
            except Exception:
                self._count("errors")
            self._count("batches")
            self._count("solves")
            served += 1

    def close(self) -> None:
        """Rank 0 of a group: tell the other ranks to leave :meth:`follow`
        (once; the engine serves no more). A no-op without a group."""
        if self.group is not None and self.rank == 0 and not self._closed:
            self._closed = True
            comm.broadcast_object(("close",), self.group)

    def drain(self) -> int:
        """Serve until the queue is empty; returns requests resolved."""
        total = 0
        while True:
            served = self.step(force=True)
            if served == 0 and self.queue.depth == 0:
                return total
            total += served

    # -- background serving ------------------------------------------------

    def start(self) -> "SolveEngine":
        """Serve from a background thread (one engine thread makes every
        launch, on :attr:`stream`; tenants submit from any thread and block
        on their tickets). On a rank of a group other than 0 the thread
        runs :meth:`follow`."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        if self.rank != 0:
            self._thread = threading.Thread(target=self.follow, name="sptrsv-follow",
                                            daemon=True)
            self._thread.start()
            return self
        self._check_front("start")
        self._stop_flag.clear()
        tick = max(self.queue.max_wait_s / 4, 1e-3)

        def loop():
            while not self._stop_flag.is_set():
                if self.step(force=False) == 0:
                    # nothing admitted: flush sub-window stragglers, then idle
                    if self.queue.depth == 0 or self.step(force=False) == 0:
                        self._stop_flag.wait(tick)

        self._thread = threading.Thread(target=loop, name="sptrsv-serve",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """End background serving (and serve what is left, under
        ``drain``). On a group, rank 0 then closes the engine and the other
        ranks wait until it has."""
        if self.rank != 0:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            return
        self._stop_flag.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain and not self._closed:
            self.drain()
        self.close()

    def __enter__(self) -> "SolveEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
