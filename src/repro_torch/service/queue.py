"""Multi-tenant request admission + same-pattern RHS coalescing.

Requests are ``(tenant, matrix, rhs)`` solves. The scheduler groups pending
requests by **(pattern sha1, value fingerprint)** — the pattern groups share
one symbolic analysis, and the value fingerprint guarantees every request
coalesced into one panel solves against identical numeric values (a tenant
that refreshed its factor lands in a new group rather than silently reading
another tenant's values). A ready group's RHS vectors are stacked into the
multi-RHS ``(n, R)`` panel the executors run as ``(k, B, R)`` tiles (the
TRSM and GEMM kernels, or the megakernel's panel form), with ``R`` padded up a small static ladder (powers of two up to
``max_batch``) so a long-lived server sees at most ``log2(max_batch)+1`` panel
widths per pattern instead of one per arrival count.

Admission window: a group is dispatchable when it holds ``max_batch``
columns or its oldest request has waited ``max_wait_s`` (0 = always ready —
the synchronous / drain regime). Fairness: when a group holds more columns
than one batch admits, the batch is filled round-robin across tenants, so
one chatty tenant cannot starve the rest of a hot pattern. Backpressure:
``submit`` raises :class:`QueueFull` beyond ``max_pending`` total columns —
the bounded-queue contract a front end can retry/shed against.

Pure numpy and threading: the reference package's queue, batch for batch.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import threading
import time

import numpy as np

from repro_torch.sparse.matrix import CSR


class QueueFull(RuntimeError):
    """Bounded-queue backpressure: the server is at ``max_pending`` columns."""


def value_key(a: CSR) -> str:
    """Fingerprint of the matrix's numeric content (pattern + values)."""
    from repro_torch.api.context import pattern_key

    h = hashlib.sha1()
    h.update(pattern_key(a).encode())
    h.update(np.ascontiguousarray(a.val, dtype=np.float32).tobytes())
    return h.hexdigest()[:16]


def rhs_ladder(max_batch: int) -> tuple:
    """Static panel-width ladder: powers of two up to (and incl.) max_batch."""
    lad = {1 << k for k in range(max_batch.bit_length()) if 1 << k <= max_batch}
    return tuple(sorted(lad | {int(max_batch)}))


def pad_width(ladder: tuple, r: int) -> int:
    """Smallest ladder width >= r (bounds the distinct panel widths)."""
    for w in ladder:
        if w >= r:
            return w
    return ladder[-1]


@dataclasses.dataclass
class SolveRequest:
    """One tenant's solve of ``matrix @ x = rhs`` (rhs: ``(n,)`` vector or an
    ``(n, k)`` panel — panels coalesce as k columns and come back as one)."""

    tenant: str
    matrix: CSR
    rhs: np.ndarray
    transpose: bool = False
    id: int = 0
    pattern: str = ""
    vkey: str = ""
    t_submit: float = 0.0

    @property
    def n_columns(self) -> int:
        return int(self.rhs.shape[1]) if self.rhs.ndim == 2 else 1

    @property
    def group(self) -> tuple:
        return (self.pattern, self.vkey, self.transpose)


class Ticket:
    """Caller-side handle for a submitted request; ``result()`` blocks until
    the engine publishes the solution (or re-raises the engine-side error)."""

    def __init__(self, request: SolveRequest):
        self.request = request
        self._done = threading.Event()
        self._result: np.ndarray | None = None
        self._error: BaseException | None = None
        self.latency_s: float = 0.0

    def _resolve(self, result=None, error=None) -> None:
        self._result = result
        self._error = error
        self.latency_s = time.monotonic() - self.request.t_submit
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.request.id} still pending")
        if self._error is not None:
            raise self._error
        return self._result


class SolveQueue:
    """Thread-safe bounded admission queue with pattern-group coalescing."""

    def __init__(self, *, max_batch: int = 8, max_wait_s: float = 0.0,
                 max_pending: int = 1024):
        if max_batch < 1 or max_pending < 1:
            raise ValueError("max_batch and max_pending must be >= 1")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.max_pending = int(max_pending)
        self.ladder = rhs_ladder(self.max_batch)
        self._lock = threading.Lock()
        self._groups: dict = collections.OrderedDict()  # group -> [Ticket]
        self._ids = itertools.count()
        self._n_columns = 0

    # -- producer side -----------------------------------------------------

    def submit(self, tenant: str, matrix: CSR, rhs: np.ndarray, *,
               transpose: bool = False) -> Ticket:
        """Enqueue one solve; raises :class:`QueueFull` at ``max_pending``."""
        from repro_torch.api.context import pattern_key

        rhs = np.asarray(rhs, np.float32)
        if rhs.ndim not in (1, 2) or rhs.shape[0] != matrix.n:
            raise ValueError(
                f"rhs shape {rhs.shape} does not match matrix n={matrix.n}")
        req = SolveRequest(
            tenant=str(tenant), matrix=matrix, rhs=rhs, transpose=transpose,
            pattern=pattern_key(matrix), vkey=value_key(matrix),
            t_submit=time.monotonic(),
        )
        ticket = Ticket(req)
        with self._lock:
            if self._n_columns + req.n_columns > self.max_pending:
                raise QueueFull(
                    f"{self._n_columns} columns pending (max_pending="
                    f"{self.max_pending}); retry or shed load")
            req.id = next(self._ids)
            self._groups.setdefault(req.group, []).append(ticket)
            self._n_columns += req.n_columns
        return ticket

    # -- consumer side -----------------------------------------------------

    @property
    def depth(self) -> int:
        """Pending RHS columns across all groups."""
        with self._lock:
            return self._n_columns

    def _ready(self, tickets: list, now: float, force: bool) -> bool:
        if force:
            return True
        if sum(t.request.n_columns for t in tickets) >= self.max_batch:
            return True
        oldest = min(t.request.t_submit for t in tickets)
        return (now - oldest) >= self.max_wait_s

    def next_batch(self, *, force: bool = False) -> list[Ticket] | None:
        """Admit one group's batch (oldest ready group first), filled
        round-robin across its tenants up to ``max_batch`` columns; ``None``
        when no group is ready. ``force`` ignores the admission window (the
        drain path)."""
        now = time.monotonic()
        with self._lock:
            group = next((g for g, ts in self._groups.items()
                          if self._ready(ts, now, force)), None)
            if group is None:
                return None
            tickets = self._groups[group]
            by_tenant = collections.OrderedDict()
            for t in tickets:
                by_tenant.setdefault(t.request.tenant, collections.deque()).append(t)
            batch, width = [], 0
            while width < self.max_batch:
                progressed = False
                for dq in by_tenant.values():
                    if dq and width + dq[0].request.n_columns <= self.max_batch:
                        t = dq.popleft()
                        batch.append(t)
                        width += t.request.n_columns
                        progressed = True
                if not progressed:
                    break
            if not batch:
                # a single request wider than max_batch: admit it alone (one
                # off-ladder panel width) rather than wedging
                t = min((dq[0] for dq in by_tenant.values() if dq),
                        key=lambda t: t.request.id)
                for dq in by_tenant.values():
                    if dq and dq[0] is t:
                        dq.popleft()
                batch, width = [t], t.request.n_columns
            left = [t for dq in by_tenant.values() for t in dq]
            if left:
                self._groups[group] = sorted(left, key=lambda t: t.request.id)
            else:
                del self._groups[group]
            self._n_columns -= width
            return sorted(batch, key=lambda t: t.request.id)

    def coalesce(self, batch: list[Ticket]) -> tuple[np.ndarray, int]:
        """Stack a batch's RHS columns into one ``(n, Rp)`` panel, ``Rp``
        padded up the static ladder; returns ``(panel, real_columns)``."""
        cols = [t.request.rhs.reshape(t.request.rhs.shape[0], -1)
                for t in batch]
        panel = np.concatenate(cols, axis=1)
        r = panel.shape[1]
        rp = pad_width(self.ladder, r)
        if rp > r:
            panel = np.pad(panel, ((0, 0), (0, rp - r)))
        return panel, r

    @staticmethod
    def scatter(batch: list[Ticket], x_panel: np.ndarray) -> None:
        """Route a solved panel's columns back to their tickets (padding
        columns dropped; ``(n,)`` requests get ``(n,)`` back)."""
        j = 0
        for t in batch:
            k = t.request.n_columns
            xs = x_panel[:, j:j + k]
            t._resolve(result=xs[:, 0] if t.request.rhs.ndim == 1 else xs)
            j += k
